"""``batch_sets.bls``: signature sets per batch the BLS pipeline dispatched in
the traced window, from the pipeline's own counters
(``device_pipeline.summary()``: the growth of ``sets_total`` and
``batches_total`` over the window). Layer: the async pipeline
(``lighthouse_tpu_torch/device_pipeline.py``).  Moves ``sets_per_s``: a
launch-bound device program costs about the same at any batch size, so
fuller batches verify more sets a second."""


def read(run):
    batches = run.counters.get("batches", 0)
    if batches <= 0:
        return None
    return run.counters["sets"] / batches
