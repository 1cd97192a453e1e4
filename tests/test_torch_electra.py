"""The port's electra operations and epoch vs the JAX package's.

``lighthouse_tpu_torch.consensus.electra`` copies the JAX package's
``electra`` module, and the port's ``per_epoch`` runs its pending deposits
and consolidations where the JAX package does.  States are an electra
chain of the JAX package's ``BeaconChainHarness`` (minimal preset, 64
validators, fake crypto), carried across by SSZ bytes
(``test_torch_types.to_port``).  Every comparison is exact (SSZ bytes):

- each execution-layer request (deposit, withdrawal full and partial and
  from a wrong address, consolidation by switch to compounding and between
  two validators) and the epoch's pending deposits (a top-up and a new
  validator with a real deposit signature) and pending consolidations;
- ``process_epoch`` on an electra state with pending deposits and
  consolidations to process, on the numpy backend and on the device
  backend with ``device="cpu"`` (the fused boundary on the CUDA kernels'
  plain versions), against the JAX package's numpy run.
"""

import contextlib

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.chain import BeaconChainHarness  # noqa: E402
from lighthouse_tpu.consensus import electra as jel  # noqa: E402
from lighthouse_tpu.consensus import per_epoch as jpe  # noqa: E402
from lighthouse_tpu.consensus import signature_sets as jsets  # noqa: E402
from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls import backends as jbackends  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch.consensus import electra as el  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import backends as pbackends  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import minimal_spec  # noqa: E402
from test_torch_types import to_port  # noqa: E402

VALIDATORS = 64
GWEI = 10 ** 9
ADDRESS = bytes(range(20))
OVERRIDES = dict(electra_fork_epoch=0, shard_committee_period=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    """The host tree-hash engine, the numpy epoch backend and the host BLS
    backend in both packages (deposit signatures are checked one at a time
    on the host, as in the JAX package); the defaults come back afterwards."""
    j_prev = jbackends.backend_name()
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    pbackends.set_backend("host")
    jbackends.set_backend("host")
    yield
    jbackends.set_backend(j_prev)
    pbackends._ACTIVE = pbackends._NAME = None
    pe.reset_for_tests()
    th.reset_for_tests()


@contextlib.contextmanager
def _restored_jax_backend():
    prev = jbackends.backend_name()
    try:
        yield
    finally:
        jbackends.set_backend(prev)


def _harness_state(slots: int):
    """(JAX electra state after ``slots`` blocks, JAX types, JAX spec)."""
    j_spec = j_minimal_spec(**OVERRIDES)
    with _restored_jax_backend():
        harness = BeaconChainHarness(validator_count=VALIDATORS, spec=j_spec, fake_crypto=True)
        harness.extend_chain(slots, attest=True)
    return harness.head_state.copy(), harness.types, j_spec


@pytest.fixture(scope="module")
def early():
    """An electra state one block in."""
    return _harness_state(1)


@pytest.fixture(scope="module")
def before_boundary():
    """An electra state one slot before the boundary into epoch 3."""
    return _harness_state(3 * j_minimal_spec(**OVERRIDES).slots_per_epoch - 1)


@pytest.fixture(scope="module")
def new_deposit():
    """(pubkey, withdrawal credentials, amount, signature): a deposit of a
    new validator, signed over the deposit domain."""
    j_spec = j_minimal_spec(**OVERRIDES)
    types = _harness_state(0)[1]
    sk = japi.SecretKey(0x5EED_DE90)
    creds = b"\x01" + bytes(11) + ADDRESS
    data = types.DepositData(pubkey=sk.public_key().to_bytes(), withdrawal_credentials=creds,
                             amount=32 * GWEI, signature=bytes(96))
    message = jsets.deposit_signature_message(data, types, j_spec)
    return sk.public_key().to_bytes(), creds, 32 * GWEI, sk.sign(message).to_bytes()


# ------------------------------------------------------------- requests


def _eth1_creds(state, i, prefix=b"\x01"):
    state.validators[i].withdrawal_credentials = prefix + bytes(11) + ADDRESS


def withdrawal_full_exit(mod, state, types, spec, _):
    _eth1_creds(state, 3)
    mod.process_withdrawal_request(state, types.WithdrawalRequest(
        source_address=ADDRESS, validator_pubkey=bytes(state.validators[3].pubkey),
        amount=spec.full_exit_request_amount), types, spec)


def withdrawal_partial(mod, state, types, spec, _):
    _eth1_creds(state, 5, spec.compounding_withdrawal_prefix)
    state.balances[5] = spec.min_activation_balance + 7 * GWEI
    mod.process_withdrawal_request(state, types.WithdrawalRequest(
        source_address=ADDRESS, validator_pubkey=bytes(state.validators[5].pubkey),
        amount=5 * GWEI), types, spec)


def withdrawal_wrong_source(mod, state, types, spec, _):
    _eth1_creds(state, 4)
    mod.process_withdrawal_request(state, types.WithdrawalRequest(
        source_address=b"\xff" * 20, validator_pubkey=bytes(state.validators[4].pubkey),
        amount=0), types, spec)


def consolidation_switch(mod, state, types, spec, _):
    _eth1_creds(state, 6)
    state.balances[6] = spec.min_activation_balance + 3 * GWEI
    pk = bytes(state.validators[6].pubkey)
    mod.process_consolidation_request(state, types.ConsolidationRequest(
        source_address=ADDRESS, source_pubkey=pk, target_pubkey=pk), types, spec)


def consolidation_merge(mod, state, types, spec, _):
    _eth1_creds(state, 8)
    _eth1_creds(state, 9, spec.compounding_withdrawal_prefix)
    mod.process_consolidation_request(state, types.ConsolidationRequest(
        source_address=ADDRESS, source_pubkey=bytes(state.validators[8].pubkey),
        target_pubkey=bytes(state.validators[9].pubkey)), types, spec)


def deposit_requests(mod, state, types, spec, deposit):
    pubkey, creds, amount, signature = deposit
    top_up = state.validators[0]
    mod.process_deposit_request(state, types.DepositRequest(
        pubkey=bytes(top_up.pubkey), withdrawal_credentials=bytes(top_up.withdrawal_credentials),
        amount=GWEI, signature=bytes(96), index=0), types, spec)
    mod.process_deposit_request(state, types.DepositRequest(
        pubkey=pubkey, withdrawal_credentials=creds, amount=amount, signature=signature,
        index=1), types, spec)


def _finalize_deposits(state, types, spec):
    """The eth1 bridge drained and the requests' slot finalized."""
    state.eth1_deposit_index = state.deposit_requests_start_index
    epoch = int(state.slot) // spec.slots_per_epoch
    state.finalized_checkpoint = types.Checkpoint(epoch=epoch + 1, root=bytes(32))


def pending_deposits(mod, state, types, spec, deposit):
    deposit_requests(mod, state, types, spec, deposit)
    _finalize_deposits(state, types, spec)
    mod.process_pending_deposits(state, types, spec)


def _queue_consolidation(state, types, spec):
    """Validator 10 exits into validator 11 at the next epoch."""
    _eth1_creds(state, 11, spec.compounding_withdrawal_prefix)
    epoch = int(state.slot) // spec.slots_per_epoch
    state.validators[10].exit_epoch = epoch
    state.validators[10].withdrawable_epoch = epoch + 1
    state.pending_consolidations = [types.PendingConsolidation(source_index=10, target_index=11)]


def pending_consolidations(mod, state, types, spec, _):
    _queue_consolidation(state, types, spec)
    mod.process_pending_consolidations(state, types, spec)


CASES = [withdrawal_full_exit, withdrawal_partial, withdrawal_wrong_source,
         consolidation_switch, consolidation_merge, deposit_requests, pending_deposits,
         pending_consolidations]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_request_matches_jax(early, new_deposit, case):
    ref, j_types, j_spec = early
    p_spec = minimal_spec(**OVERRIDES)
    p_types = build_types(p_spec.preset)
    theirs, ours = ref.copy(), to_port(ref, p_types)
    before = ours.as_ssz_bytes()
    case(jel, theirs, j_types, j_spec, new_deposit)
    case(el, ours, p_types, p_spec, new_deposit)
    assert ours.as_ssz_bytes() == theirs.as_ssz_bytes()
    if case is not withdrawal_wrong_source:
        assert ours.as_ssz_bytes() != before, "the case changed nothing"


def test_pending_deposit_adds_a_validator(early, new_deposit):
    """The new validator's deposit passes its signature check and joins
    the registry in both packages."""
    ref, j_types, j_spec = early
    p_spec = minimal_spec(**OVERRIDES)
    p_types = build_types(p_spec.preset)
    ours = to_port(ref, p_types)
    pending_deposits(el, ours, p_types, p_spec, new_deposit)
    assert len(ours.validators) == VALIDATORS + 1
    assert bytes(ours.validators[-1].pubkey) == new_deposit[0]
    assert len(ours.pending_deposits) == 0


# ----------------------------------------------------------------- epoch


def _epoch_state(mod, state, types, spec, deposit):
    """Work for the epoch's electra phases: two deposit requests (a top-up,
    a new validator) due this epoch and a consolidation whose source is
    withdrawable next epoch."""
    deposit_requests(mod, state, types, spec, deposit)
    _finalize_deposits(state, types, spec)
    _queue_consolidation(state, types, spec)


@pytest.mark.parametrize("backend", ["numpy", "device-cpu"])
def test_process_epoch_matches_jax(before_boundary, new_deposit, backend, monkeypatch):
    """``process_epoch`` on an electra state with pending deposits and a
    pending consolidation: the port's state equals the JAX package's numpy
    run, on the port's numpy backend and on its device backend on the CPU,
    which runs the fused boundary and then recomputes the balances the
    electra phases moved on the scalar path."""
    ref, j_types, j_spec = before_boundary
    p_spec = minimal_spec(**OVERRIDES)
    p_types = build_types(p_spec.preset)
    theirs, ours = ref.copy(), to_port(ref, p_types)
    _epoch_state(jel, theirs, j_types, j_spec, new_deposit)
    _epoch_state(el, ours, p_types, p_spec, new_deposit)
    assert ours.as_ssz_bytes() == theirs.as_ssz_bytes()
    boundaries = []
    if backend == "device-cpu":
        pe.configure(backend="device", fused_boundary=True, device="cpu")
        real = pe._run_boundary

        def counted(plan, *, in_leak):
            boundaries.append(plan.n)
            return real(plan, in_leak=in_leak)

        monkeypatch.setattr(pe, "_run_boundary", counted)
    jpe.process_epoch(theirs, j_types, j_spec)
    pe.process_epoch(ours, p_types, p_spec)
    assert ours.as_ssz_bytes() == theirs.as_ssz_bytes()
    assert len(ours.validators) == VALIDATORS + 1
    assert len(ours.pending_deposits) == 0 and len(ours.pending_consolidations) == 0
    assert boundaries == ([VALIDATORS] if backend == "device-cpu" else [])
