"""Batch-axis registry: the batching contract of every device entry point
of the port.

One entry per device program in ``ops/``, in the mold of the JAX package's
``lighthouse_tpu/ops/batch_axes.py`` and with the same axes: the op's name,
the batch axis of its batched arguments, which arguments are replicated
(the same for every batch row), whether the program reduces over the batch
axis (then a batch must never be split across devices or retries), and
whether its outputs keep the batch axis.

Keys are ``"<repo-relative path>:<function name>"``.  This module stays a
plain dict literal with no imports, so tools can read it with
``ast.literal_eval`` without importing the package.
"""

#: batching contract per device entry point (see the module docstring).
BATCH_AXES = {
    "lighthouse_tpu_torch/ops/verify.py:_device_verify": {
        "op": "bls_verify",
        "batch_axis": 0,
        "batched_args": ["pk", "sig", "msg", "wbits", "live"],
        "replicated_args": [],
        "reduces_over_batch": False,
        "out_batched": False,
        "notes": "per-set pairing rows; the N+1'th (-g1, W) pair is "
                 "assembled inside the program from a batch-wide MSM",
    },
    "lighthouse_tpu_torch/ops/sha256_device.py:_sha256_64byte_batch": {
        "op": "sha256_pairs",
        "batch_axis": 0,
        "batched_args": ["words"],
        "replicated_args": [],
        "reduces_over_batch": False,
        "out_batched": True,
        "notes": "embarrassingly parallel over 64-byte blocks",
    },
    "lighthouse_tpu_torch/ops/tree_hash.py:_tree_hash_subtrees": {
        "op": "tree_hash",
        "batch_axis": 0,
        "batched_args": ["leaves"],
        "replicated_args": [],
        "reduces_over_batch": False,
        "out_batched": True,
        "notes": "fused depth-5 Merkle subtrees; embarrassingly parallel "
                 "over the subtree axis (every output level keeps it)",
    },
    "lighthouse_tpu_torch/ops/kzg_device.py:_device_kzg_batch": {
        "op": "kzg_batch",
        "batch_axis": 0,
        "batched_args": ["c", "p", "r_bits", "rz_bits"],
        "replicated_args": ["ry_bits", "tau", "g2gen"],
        "reduces_over_batch": True,
        "out_batched": False,
        "notes": "tree-sum lincombs reduce the blob axis into one "
                 "2-pairing",
    },
}
