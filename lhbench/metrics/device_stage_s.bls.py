"""``device_stage_s.bls``: seconds of a batch's device stage, dispatch (the
host issuing the program's launches) plus the wait for the card, mean over
the batches of the traced window, from the flight records' stages
(``device_batch_dispatch`` and ``device_batch_wait`` spans of
``ops/verify.py``).  Layer: the device program (``ops/verify.py:
_device_verify`` on ``ops/pairing.py``, ``ec.py``, ``tower.py``, under
``device_supervisor.py``).  Moves ``sets_per_s``: the pipeline builds the
next batch while one runs, so the longer of the two stages paces it, and
every call waits out at least one whole device stage."""


def read(run):
    stages = [r["stages_s"] for r in run.flight if "stages_s" in r and "dispatch" in r["stages_s"]]
    if not stages:
        return None
    return sum(s["dispatch"] + s.get("wait", 0.0) for s in stages) / len(stages)
