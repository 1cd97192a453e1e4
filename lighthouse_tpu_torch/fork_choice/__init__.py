"""Fork choice: proto-array DAG + spec wrapper.

Equivalent of the reference's ``consensus/proto_array`` and
``consensus/fork_choice`` crates.  A copy of the JAX package's
``lighthouse_tpu/fork_choice/``: the votes stay dense numpy arrays on the
host, as there.
"""

from .fork_choice import (
    ForkChoice,
    ForkChoiceError,
    InvalidAttestation,
    InvalidBlock,
    compute_unrealized_checkpoints,
    justified_balances,
)
from .proto_array import (
    ExecutionStatus,
    InvalidAncestorError,
    ProtoArray,
    ProtoArrayError,
    ProtoNode,
    VoteTracker,
)

__all__ = [
    "ForkChoice",
    "ForkChoiceError",
    "InvalidAttestation",
    "InvalidBlock",
    "compute_unrealized_checkpoints",
    "justified_balances",
    "ExecutionStatus",
    "InvalidAncestorError",
    "ProtoArray",
    "ProtoArrayError",
    "ProtoNode",
    "VoteTracker",
]
