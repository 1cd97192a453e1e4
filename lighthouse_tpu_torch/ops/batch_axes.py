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
    "lighthouse_tpu_torch/ops/epoch_device.py:_deltas_kernel": {
        "op": "epoch_deltas",
        "batch_axis": 0,
        "batched_args": [
            "eff_bal", "activation_epoch", "exit_epoch",
            "withdrawable_epoch", "slashed", "prev_part", "inactivity",
        ],
        "replicated_args": [
            "previous_epoch", "base_reward_per_increment",
            "total_active_balance", "increment", "inactivity_score_bias",
            "inactivity_score_recovery_rate", "quotient",
        ],
        "reduces_over_batch": True,
        "out_batched": True,
        "notes": "participating-increment sums span the whole registry: "
                 "the mesh split adds the shards' raw sums on the first "
                 "member before each shard finishes its rows; no "
                 "split-batch retry (NO_SPLIT_OPS)",
    },
    "lighthouse_tpu_torch/ops/shuffle_device.py:_shuffle_kernel": {
        "op": "shuffle",
        "batch_axis": 0,
        "batched_args": ["values"],
        "replicated_args": ["pivots", "digests", "n_live"],
        "reduces_over_batch": True,
        "out_batched": True,
        "notes": "swap-or-not rounds gather partner lanes across the whole "
                 "index array (a[flip]): the batch is never split "
                 "(NO_SPLIT_OPS)",
    },
    "lighthouse_tpu_torch/ops/shuffle_device.py:_proposer_kernel": {
        "op": "proposer_select",
        "batch_axis": 0,
        "batched_args": ["eff_act"],
        "replicated_args": [
            "seed_words", "pivots", "rbytes", "m_live", "max_eb",
        ],
        "reduces_over_batch": True,
        "out_batched": False,
        "notes": "the candidate walk gathers effective balances at "
                 "shuffle-derived positions spanning the whole active "
                 "list; outputs are (S,) per-slot scalars",
    },
    "lighthouse_tpu_torch/ops/shuffle_device.py:_boundary_kernel": {
        "op": "epoch_boundary",
        "batch_axis": 0,
        "batched_args": [
            "eff_bal", "activation_epoch", "exit_epoch",
            "withdrawable_epoch", "slashed", "prev_part", "inactivity",
            "balance", "act_elig_epoch", "eb_cap", "active_idx",
        ],
        "replicated_args": [
            "sh_pivots", "sh_digests", "seed_words", "prop_pivots",
            "rbytes", "previous_epoch", "base_reward_per_increment",
            "total_active_balance", "increment", "inactivity_score_bias",
            "inactivity_score_recovery_rate", "quotient", "current_epoch",
            "downward", "upward", "ejection_balance", "far_future",
            "finalized_epoch", "max_eb", "queue_lo", "queue_hi", "m_live",
        ],
        "reduces_over_batch": True,
        "out_batched": [
            True, True, True, True, True, True,  # per-validator arrays
            True,          # shuffled active list (same padded batch axis)
            False, False,  # per-slot proposer table + found flags
        ],
        "notes": "fused boundary: deltas sums span the registry AND the "
                 "shuffle/proposer stages gather across lanes — the mesh "
                 "split combines the sums, exchanges the shuffle's blocks "
                 "every round and walks the proposers on the first "
                 "member; no split-batch retry (NO_SPLIT_OPS)",
    },
}
