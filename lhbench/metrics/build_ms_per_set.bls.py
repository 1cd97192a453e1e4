"""``build_ms_per_set.bls``: host milliseconds of the batch build a signature
set, over the batches of the traced window: the flight records' ``setup``
stage (``device_telemetry.FLIGHT_RECORDER``; the span ``device_batch_setup``
around ``ops/verify.py:build_device_batch``: random weights, subgroup
checks, hash-to-G2, limb packing, upload) summed, over their live sets.
Layer: the host build (``ops/verify.py``, ``crypto/bls/curve.py``,
``hash_to_curve.py``).  Moves ``sets_per_s``: the build holds the
interpreter lock that the launches and the calls' parse need too."""


def read(run):
    sets = sum(r.get("n_live", 0) for r in run.flight if "stages_s" in r)
    if sets <= 0:
        return None
    return 1000.0 * sum(r["stages_s"].get("setup", 0.0) for r in run.flight
                        if "stages_s" in r) / sets
