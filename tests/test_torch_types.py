"""The port's SSZ types and state hash cache vs the JAX package.

``lighthouse_tpu_torch.types`` is the port's copy of the JAX package's
pure-Python ``types`` layer; SSZ bytes carry a state across.  The JAX
package's ``interop_genesis_state`` (minimal preset) is encoded, decoded
by the port, re-encoded to the same bytes and hashed to the same root, on
the host engine and on the device engine (``device="cpu"``: the CUDA
kernels' plain versions).  The cases of ``tests/test_tree_cache.py`` and
``tests/test_ssz.py`` are re-pointed at the port, and every root and every
encoding is also held against the JAX package's.  All comparisons are exact
(bytes).
"""

import hashlib
import os
import random

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu.consensus.genesis import interop_genesis_state  # noqa: E402
from lighthouse_tpu.types import ssz as jssz  # noqa: E402
from lighthouse_tpu.types.containers import build_types as j_build_types  # noqa: E402
from lighthouse_tpu.types.spec import minimal_spec as j_minimal_spec  # noqa: E402
from lighthouse_tpu_torch import device_pipeline, device_supervisor  # noqa: E402
from lighthouse_tpu_torch.ops import sha256_device as sd  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.types import ssz  # noqa: E402
from lighthouse_tpu_torch.types.containers import build_types  # noqa: E402
from lighthouse_tpu_torch.types.spec import MINIMAL_PRESET, minimal_spec  # noqa: E402
from lighthouse_tpu_torch.types.ssz import (  # noqa: E402
    Bitlist,
    Bitvector,
    ByteList,
    Container,
    List,
    Vector,
    boolean,
    bytes32,
    uint8,
    uint16,
    uint64,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts on the host engine, as the JAX package's do; the
    device-engine tests turn it on with ``device="cpu"``."""
    th.reset_for_tests()
    th.configure(enabled=False)
    yield
    sd.uninstall_device_hash()
    device_pipeline.reset_for_tests()
    device_supervisor.reset_for_tests()
    th.reset_for_tests()


def _spec_kwargs():
    return dict(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                deneb_fork_epoch=None)


@pytest.fixture(scope="module")
def setup():
    """(reference state, reference types, port types): 32 interop validators."""
    j_spec = j_minimal_spec(**_spec_kwargs())
    j_types = j_build_types(j_spec.preset)
    ref = interop_genesis_state(32, j_types, j_spec, genesis_time=1_600_000_000)
    return ref, j_types, build_types(minimal_spec(**_spec_kwargs()).preset)


def to_port(ref, p_types):
    """The JAX package's state ``ref`` as the port's, by its SSZ bytes (the
    one way the port's tests carry the JAX package's data across)."""
    return p_types.state[type(ref).fork_name].from_ssz_bytes(ref.as_ssz_bytes())


def uncached_root(state, ssz_mod=ssz) -> bytes:
    """The plain recursive merkleization (cache bypassed)."""
    t = state.ssz_type
    return ssz_mod.merkleize(
        [ft.hash_tree_root(getattr(state, name)) for name, ft in t.field_types.items()])


def _same(port_state, ref_state):
    """Port and reference states agree: same bytes, same cached root, and the
    port's cached root equals its uncached one."""
    assert port_state.as_ssz_bytes() == ref_state.as_ssz_bytes()
    root = port_state.hash_tree_root()
    assert root == ref_state.hash_tree_root()
    assert root == uncached_root(port_state)


# ------------------------------------------------- the state carried across


def test_preset_matches_jax():
    from lighthouse_tpu.types.spec import MAINNET_PRESET as J_MAINNET
    from lighthouse_tpu.types.spec import MINIMAL_PRESET as J_MINIMAL

    from lighthouse_tpu_torch.types.spec import MAINNET_PRESET

    assert vars(MINIMAL_PRESET) == vars(J_MINIMAL)
    assert vars(MAINNET_PRESET) == vars(J_MAINNET)


def test_interop_genesis_state_bytes_and_root_on_host_engine():
    j_spec = j_minimal_spec(**_spec_kwargs())
    j_types = j_build_types(j_spec.preset)
    ref = interop_genesis_state(16, j_types, j_spec, genesis_time=1_600_000_000)
    data = ref.as_ssz_bytes()
    port = to_port(ref, build_types(minimal_spec(**_spec_kwargs()).preset))
    assert type(port).fork_name == type(ref).fork_name
    assert port.as_ssz_bytes() == data
    assert port.hash_tree_root() == ref.hash_tree_root()


def test_interop_genesis_state_root_on_device_engine():
    """The port's device engines on the CPU (the kernels' plain versions):
    the big fields' trees on DeviceLeafTree, the SSZ seam on the hybrid pair
    hash with a low threshold, so both kernels' plain versions carry part
    of the root."""
    j_spec = j_minimal_spec(**_spec_kwargs())
    j_types = j_build_types(j_spec.preset)
    ref = interop_genesis_state(16, j_types, j_spec, genesis_time=1_600_000_000)
    port = to_port(ref, build_types(minimal_spec(**_spec_kwargs()).preset))
    th.configure(enabled=True, device="cpu", device_min_subtrees=1, device_min_blocks=32)
    sd.install_device_hash(threshold_blocks=32, device="cpu")
    sd.reset_routes()
    assert port.hash_tree_root() == ref.hash_tree_root()
    assert sd.ROUTE_BLOCKS["device_subtree"] > 0
    assert sd.ROUTE_BLOCKS["device_pairs"] > 0
    port.balances[3] += 17
    port.validators[5].slashed = True
    ref.balances[3] += 17
    ref.validators[5].slashed = True
    assert port.hash_tree_root() == ref.hash_tree_root()


def test_state_root_defaults_to_the_card(setup):
    """Device tree hashing is on by default, on ``"cuda"``: without a card
    a state's root raises instead of hashing on the host."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    ref, _, p_types = setup
    th.reset_for_tests()
    assert th.enabled()
    with pytest.raises(RuntimeError, match="is_available"):
        to_port(ref, p_types).hash_tree_root()
    with pytest.raises(RuntimeError, match="is_available"):
        th.DeviceLeafTree(1 << 10)


def test_hash_pairs_device_as_the_ssz_seam(setup):
    """``tests/test_sha256_device.py::test_merkleize_with_device_kernel``:
    the pair op as the SSZ seam gives the reference's root."""
    ref, _, p_types = setup
    real = ssz._hash_pairs
    ssz.set_hash_pairs_impl(lambda data: sd.hash_pairs_device(data, device="cpu"))
    try:
        assert to_port(ref, p_types).hash_tree_root() == ref.hash_tree_root()
    finally:
        ssz.set_hash_pairs_impl(real)


# ---------------------------------- tests/test_tree_cache.py, re-pointed


def test_cached_equals_uncached_fresh(setup):
    ref, _, p_types = setup
    _same(to_port(ref, p_types), ref)


def test_cached_tracks_mutations(setup):
    ref, _, p_types = setup
    st, rt = to_port(ref, p_types), ref.copy()
    st.hash_tree_root()

    def both(fn):
        fn(st)
        fn(rt)
        _same(st, rt)

    def balances(s):
        s.balances[3] += 17

    def validator(s):
        s.validators[5].slashed = True
        s.validators[5].exit_epoch = 9

    def root_vectors(s):
        s.block_roots[7] = b"\x42" * 32
        s.state_roots[2] = b"\x43" * 32
        s.randao_mixes[1] = b"\x44" * 32

    def participation(s):
        s.current_epoch_participation[4] = 7

    def scalars(s):
        s.slot = int(s.slot) + 1
        s.latest_block_header.state_root = b"\x55" * 32

    def slashings(s):
        s.slashings[0] = 123456

    for fn in (balances, validator, root_vectors, participation, scalars, slashings):
        both(fn)


def test_cached_tracks_appends(setup):
    ref, _, p_types = setup
    st, rt = to_port(ref, p_types), ref.copy()
    st.hash_tree_root()
    for s in (st, rt):
        v = s.validators[0].copy()
        v.pubkey = b"\x09" * 48
        s.validators.append(v)
        s.balances.append(32_000_000_000)
        s.current_epoch_participation.append(0)
        s.previous_epoch_participation.append(0)
        s.inactivity_scores.append(0)
    _same(st, rt)


def test_copy_isolates_cache(setup):
    ref, _, p_types = setup
    st = to_port(ref, p_types)
    r0 = st.hash_tree_root()
    st2 = st.copy()
    st2.balances[0] += 1
    r2 = st2.hash_tree_root()
    assert r2 != r0
    assert st.hash_tree_root() == r0 == ref.hash_tree_root()
    assert r2 == uncached_root(st2)


def test_single_balance_change_is_olog_n(setup):
    ref, _, p_types = setup
    st = to_port(ref, p_types)
    st.hash_tree_root()
    calls = {"blocks": 0}
    real = ssz._hash_pairs

    def counting(buf):
        calls["blocks"] += len(buf) // 64
        return real(buf)

    ssz.set_hash_pairs_impl(counting)
    try:
        st.balances[1] += 1
        st.hash_tree_root()
    finally:
        ssz.set_hash_pairs_impl(real)
    assert calls["blocks"] <= 150, f"{calls['blocks']} hashes for one balance change"


@pytest.mark.parametrize("engine", ["host", "device"])
def test_larger_state_randomized_equivalence(engine):
    j_spec = j_minimal_spec(**_spec_kwargs())
    j_types = j_build_types(j_spec.preset)
    rt = interop_genesis_state(64, j_types, j_spec, genesis_time=1_600_000_000)
    if engine == "device":
        th.configure(enabled=True, device="cpu", device_min_subtrees=1, device_min_blocks=16)
    st = to_port(rt, build_types(minimal_spec(**_spec_kwargs()).preset))
    st.hash_tree_root()
    rng = random.Random(7)
    for round_ in range(12):
        op = rng.randrange(5)
        if op == 0:
            i, v = rng.randrange(len(st.balances)), rng.randrange(1 << 40)
            st.balances[i] = rt.balances[i] = v
        elif op == 1:
            i = rng.randrange(len(st.validators))
            eff, act = rng.randrange(1 << 40), rng.randrange(1 << 20)
            for s in (st, rt):
                s.validators[i].effective_balance = eff
                s.validators[i].activation_epoch = act
        elif op == 2:
            i = rng.randrange(len(st.block_roots))
            root = bytes(rng.randrange(256) for _ in range(32))
            st.block_roots[i] = rt.block_roots[i] = root
        elif op == 3:
            i, v = rng.randrange(len(st.inactivity_scores)), rng.randrange(100)
            st.inactivity_scores[i] = rt.inactivity_scores[i] = v
        else:
            i, v = rng.randrange(len(st.current_epoch_participation)), rng.randrange(8)
            st.current_epoch_participation[i] = rt.current_epoch_participation[i] = v
        assert st.hash_tree_root() == rt.hash_tree_root() == uncached_root(st), \
            f"divergence at round {round_}"


def test_native_hash_pairs_matches_hashlib():
    buf = os.urandom(64 * 33)
    assert ssz._hash_pairs(buf) == ssz._hash_pairs_hashlib(buf) == jssz._hash_pairs(buf)


def test_composite_list_caches_track_changes(setup):
    ref, j_types, p_types = setup
    st, rt = to_port(ref, p_types), ref.copy()
    st.hash_tree_root()
    for k, (a, b, c) in enumerate(((b"\x01", 5, b"\x02"), (b"\x03", 6, b"\x04"))):
        st.eth1_data_votes.append(p_types.Eth1Data(
            deposit_root=a * 32, deposit_count=b, block_hash=c * 32))
        rt.eth1_data_votes.append(j_types.Eth1Data(
            deposit_root=a * 32, deposit_count=b, block_hash=c * 32))
        _same(st, rt)
    st.eth1_data_votes[0] = p_types.Eth1Data(
        deposit_root=b"\x05" * 32, deposit_count=7, block_hash=b"\x06" * 32)
    rt.eth1_data_votes[0] = j_types.Eth1Data(
        deposit_root=b"\x05" * 32, deposit_count=7, block_hash=b"\x06" * 32)
    _same(st, rt)
    st.eth1_data_votes = []
    rt.eth1_data_votes = []
    _same(st, rt)


def test_composite_list_cache_detects_in_place_mutation(setup):
    ref, j_types, p_types = setup
    st, rt = to_port(ref, p_types), ref.copy()
    st.eth1_data_votes.append(p_types.Eth1Data(
        deposit_root=b"\x01" * 32, deposit_count=5, block_hash=b"\x02" * 32))
    rt.eth1_data_votes.append(j_types.Eth1Data(
        deposit_root=b"\x01" * 32, deposit_count=5, block_hash=b"\x02" * 32))
    st.hash_tree_root()
    st.eth1_data_votes[0].deposit_count = 99
    rt.eth1_data_votes[0].deposit_count = 99
    _same(st, rt)


# --------------------------------------- tests/test_ssz.py, re-pointed


def test_uint_roundtrip():
    assert uint64.serialize(0x0102030405060708) == bytes.fromhex("0807060504030201")
    assert uint64.deserialize(uint64.serialize(12345)) == 12345
    assert uint16.serialize(0xABCD) == b"\xcd\xab"


def test_uint_htr_is_padded_le():
    assert uint64.hash_tree_root(5) == (5).to_bytes(8, "little") + b"\x00" * 24


def test_vector_uint():
    v = Vector(uint64, 4)
    vals = [1, 2, 3, 4]
    assert v.deserialize(v.serialize(vals)) == vals
    assert v.hash_tree_root(vals) == b"".join(x.to_bytes(8, "little") for x in vals)
    assert v.hash_tree_root(vals) == jssz.Vector(jssz.uint64, 4).hash_tree_root(vals)


def test_list_uint_htr():
    lst = List(uint64, 8)
    expect = hashlib.sha256(
        hashlib.sha256(b"\x00" * 64).digest() + (0).to_bytes(32, "little")).digest()
    assert lst.hash_tree_root([]) == expect
    vals = [1, 2, 3]
    packed = b"".join(x.to_bytes(8, "little") for x in vals) + b"\x00" * 8
    body = hashlib.sha256(packed + b"\x00" * 32).digest()
    assert lst.hash_tree_root(vals) == hashlib.sha256(body + (3).to_bytes(32, "little")).digest()
    assert lst.hash_tree_root(vals) == jssz.List(jssz.uint64, 8).hash_tree_root(vals)


def test_bitvector():
    bv = Bitvector(10)
    bits = [True, False] * 5
    data = bv.serialize(bits)
    assert len(data) == 2 and data == jssz.Bitvector(10).serialize(bits)
    assert bv.deserialize(data) == bits
    with pytest.raises(ValueError):
        bv.deserialize(b"\xff\xff")


def test_bitlist():
    bl, jbl = Bitlist(16), jssz.Bitlist(16)
    for bits in ([], [True], [False] * 8, [True] * 16, [True, False, True]):
        assert bl.serialize(bits) == jbl.serialize(bits)
        assert bl.deserialize(bl.serialize(bits)) == bits
        assert bl.hash_tree_root(bits) == jbl.hash_tree_root(bits)
    assert bl.serialize([]) == b"\x01"
    with pytest.raises(ValueError):
        bl.deserialize(b"\x00")


class Inner(Container):
    fields = {"a": uint64, "b": bytes32}


class Outer(Container):
    fields = {
        "x": uint8,
        "items": List(uint64, 32),
        "inner": Inner.ssz_type,
        "flag": boolean,
        "blob": ByteList(64),
    }


class JInner(jssz.Container):
    fields = {"a": jssz.uint64, "b": jssz.bytes32}


class JOuter(jssz.Container):
    fields = {
        "x": jssz.uint8,
        "items": jssz.List(jssz.uint64, 32),
        "inner": JInner.ssz_type,
        "flag": jssz.boolean,
        "blob": jssz.ByteList(64),
    }


def _outer_pair(**kw):
    inner = kw.pop("inner", None)
    o = Outer(**kw, **({"inner": Inner(**inner)} if inner else {}))
    j = JOuter(**kw, **({"inner": JInner(**inner)} if inner else {}))
    return o, j


def test_container_roundtrip():
    o, j = _outer_pair(x=7, items=[1, 2, 3], inner={"a": 9, "b": b"\x11" * 32}, flag=True,
                       blob=b"hi")
    data = o.as_ssz_bytes()
    assert data == j.as_ssz_bytes()
    o2 = Outer.from_ssz_bytes(data)
    assert o == o2 and o2.items == [1, 2, 3] and o2.inner.a == 9
    assert o2.hash_tree_root() == j.hash_tree_root()


def test_container_defaults():
    o = Outer()
    assert o.x == 0 and o.items == [] and o.flag is False
    assert o.inner == Inner(a=0, b=b"\x00" * 32)
    assert o.hash_tree_root() == JOuter().hash_tree_root()


def test_container_htr_manual():
    i = Inner(a=1, b=b"\x22" * 32)
    expect = hashlib.sha256(((1).to_bytes(8, "little") + b"\x00" * 24) + b"\x22" * 32).digest()
    assert i.hash_tree_root() == expect == JInner(a=1, b=b"\x22" * 32).hash_tree_root()


def test_fixed_size_flags():
    assert Inner.ssz_type.is_fixed_size and Inner.ssz_type.fixed_size == 40
    assert not Outer.ssz_type.is_fixed_size


def test_variable_container_offsets():
    o, j = _outer_pair(x=255, items=[7] * 5, blob=b"\xaa" * 10)
    data = o.as_ssz_bytes()
    assert int.from_bytes(data[1:5], "little") == 50
    assert data == j.as_ssz_bytes()
    assert Outer.from_ssz_bytes(data) == o


def test_nested_variable_list():
    t = List(List(uint64, 4), 4)
    v = [[1], [2, 3], []]
    assert t.deserialize(t.serialize(v)) == v
    assert t.serialize(v) == jssz.List(jssz.List(jssz.uint64, 4), 4).serialize(v)


def test_merkleize_limit_padding():
    c = b"\x01" * 32
    h01 = hashlib.sha256(c + ssz.ZERO_CHUNK).digest()
    expect = hashlib.sha256(h01 + ssz.ZERO_HASHES[1]).digest()
    assert ssz.merkleize([c], 4) == expect == jssz.merkleize([c], 4)
    assert ssz.ZERO_HASHES == jssz.ZERO_HASHES
