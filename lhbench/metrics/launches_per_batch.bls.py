"""``launches_per_batch.bls``: cUDA kernels the card ran in the traced window
(``torch.profiler``, device activity only; copies and fills not counted)
over the batches dispatched in it (flight records).  Layer: the device
program.  Moves ``sets_per_s``: the program is bound by the host's launches,
which share the interpreter lock with the build, so fewer launches shorten
every batch's device stage."""


def read(run):
    if run.trace is None or not run.flight:
        return None
    return len(run.trace.kernels) / len(run.flight)
