"""Data-model layer: SSZ, chain specs, and consensus containers.

A copy of the JAX package's pure-Python ``lighthouse_tpu/types`` (``spec``,
``ssz``, ``containers``, ``tree_cache``), which occupies the slot of the
reference's ``consensus/types`` crate (``EthSpec`` presets, ``ChainSpec``
runtime constants, SSZ containers across all forks).  ``BeaconState`` keeps
per-validator data as plain Python lists of values and containers; SSZ
bytes carry a state between the two packages (``as_ssz_bytes`` /
``from_ssz_bytes``).  The incremental state hash cache
(``tree_cache.StateTreeHashCache``) takes its big-field engine from
``lighthouse_tpu_torch.ops.tree_hash`` when device tree hashing is on.
"""

from .ssz import (  # noqa: F401
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Vector,
    boolean,
    bytes4,
    bytes32,
    bytes48,
    bytes96,
    hash_tree_root,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
