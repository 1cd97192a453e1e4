"""The port's multi-node simulator (``simulator.py``) vs the JAX package's.

``lighthouse_tpu_torch.simulator`` copies the JAX package's module: N
in-process nodes (fake-crypto harness chains) with partitioned validators
gossip over the hub, each performing its own duties.  The port's nodes run
on its CPU routes (host tree hashing, the numpy epoch backend); the JAX
package's run under its own fake backend, as its tests run them.  Blocks
carry the default graffiti, which names the client version (``0.1.0`` in
the port, ``0.2.0`` in the JAX package), so the parity case pins one
version string in both packages.  Every comparison is exact:

- parity: both packages' ``Simulator(node_count=3, validator_count=16)``
  run five epochs slot by slot: the same head root after every slot, the
  same finalized and justified checkpoints and the same per-node head
  slots at the end;
- the JAX package's ``test_simulator.py`` cases re-pointed at the port
  (the basic three-node run on the parity case's simulator; the secured
  TCP + discv5 topology, which the JAX package skips without the
  ``cryptography`` package and the port runs on its own ciphers; a node
  lost mid-run).
"""

import pytest

pytest.importorskip("jax")

from lighthouse_tpu import simulator as jsim  # noqa: E402
from lighthouse_tpu.chain import graffiti_calculator as jgraffiti  # noqa: E402
from lighthouse_tpu_torch import logs  # noqa: E402
from lighthouse_tpu_torch.chain import graffiti_calculator  # noqa: E402
from lighthouse_tpu_torch.consensus import per_epoch as pe  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.backends import set_backend  # noqa: E402
from lighthouse_tpu_torch.ops import tree_hash as th  # noqa: E402
from lighthouse_tpu_torch.simulator import Simulator  # noqa: E402
from test_torch_chain import jax_backend, one_torch_thread, port_cpu  # noqa: E402,F401

EPOCHS = 5


@pytest.fixture(autouse=True)
def _fake():
    set_backend("fake")
    yield


@pytest.fixture(scope="module")
def parity_run():
    """Both packages' three-node simulators, five epochs slot by slot on one
    version string: the per-slot heads, and the port's simulator (still up,
    for the basic run's checks) with its log-ring mark."""
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    logs.setup_logging()
    tail = logs.RING.tail(1)
    seq_before = tail[-1]["seq"] if tail else 0
    with pytest.MonkeyPatch.context() as mp, jax_backend("fake"):
        mp.setattr(graffiti_calculator, "_CL_VERSION", jgraffiti._CL_VERSION)
        port = Simulator(node_count=3, validator_count=16)
        ref = jsim.Simulator(node_count=3, validator_count=16)
        heads = []
        try:
            for _ in range(EPOCHS * port.spec.slots_per_epoch):
                slot = port.run_slot()
                assert ref.run_slot() == slot
                heads.append((slot, port.nodes[0].chain.head_root,
                              ref.nodes[0].chain.head_root))
            yield {"port": port, "ref": ref, "heads": heads,
                   "seq_before": seq_before}
        finally:
            port.shutdown()
            ref.shutdown()
            pe.reset_for_tests()
            th.reset_for_tests()


def test_simulator_matches_jax_every_slot(parity_run):
    port, ref = parity_run["port"], parity_run["ref"]
    assert len(parity_run["heads"]) == EPOCHS * port.spec.slots_per_epoch
    for slot, p_head, j_head in parity_run["heads"]:
        assert p_head == j_head, f"head roots differ at slot {slot}"
    for p, j in zip(port.nodes, ref.nodes):
        assert p.chain.finalized_checkpoint() == j.chain.finalized_checkpoint()
        assert p.chain.justified_checkpoint() == j.chain.justified_checkpoint()
        assert p.chain.head_slot() == j.chain.head_slot()
        assert p.keys == j.keys
    assert port.nodes[0].chain.finalized_checkpoint()[0] >= 2


def test_basic_sim_three_nodes_finalize(parity_run):
    sim = parity_run["port"]
    sim.check_heads_agree()
    sim.check_finalization(min_epoch=2)

    # a multi-node run leaves structured records in the log ring: block
    # imports with fields, peer lifecycle, and the finalization advance
    records = [r for r in logs.RING.tail(logs.RING.capacity)
               if r["seq"] > parity_run["seq_before"]]
    by_msg = {}
    for r in records:
        by_msg.setdefault(r["message"], []).append(r)
    imports = by_msg.get("block imported", [])
    assert len(imports) >= 10, "an epoch of imports must be logged"
    assert {"slot", "root", "delay_s", "import_s"} <= set(imports[0]["fields"])
    assert by_msg.get("peer connected"), "peer lifecycle must be logged"
    assert by_msg.get("finalized checkpoint advanced"), \
        "finalization must be logged"
    # every node contributed blocks (validators are partitioned)
    proposers = set()
    chain = sim.nodes[0].chain
    spe = sim.nodes[0].harness.spec.slots_per_epoch
    for slot in range(1, spe * EPOCHS):
        root = chain.block_root_at_slot(slot)
        blk = chain.get_block(root) if root else None
        if blk is not None and int(blk.message.slot) == slot:
            proposers.add(int(blk.message.proposer_index) % 3)
    assert proposers == {0, 1, 2}


def test_sim_finalizes_over_secured_tcp_with_discv5():
    """Three nodes discover each other through a discv5 boot node, connect
    over the secured fabric (multistream -> noise -> yamux on real
    sockets), and keep one chain finalizing."""
    sim = Simulator(node_count=3, validator_count=16,
                    transport="tcp_secured", discovery="discv5")
    try:
        # discovery actually connected the mesh
        for n in sim.nodes:
            assert len(n.node.endpoint.connected_peers()) >= 2, (
                n.index, n.node.endpoint.connected_peers())
        sim.run_epochs(5)
        sim.check_heads_agree()
        sim.check_finalization(min_epoch=2)
    finally:
        sim.shutdown()


def test_sim_survives_node_loss():
    """With one of three nodes gone, the remaining 2/3 of validators keep
    the chain advancing and justifying."""
    sim = Simulator(node_count=3, validator_count=16)
    try:
        sim.run_epochs(2)
        lost = sim.nodes.pop()
        lost.shutdown()
        before = sim.nodes[0].chain.head_slot()
        sim.run_epochs(3)
        sim.check_heads_agree()
        assert sim.nodes[0].chain.head_slot() > before
        j_epoch, _ = sim.nodes[0].chain.justified_checkpoint()
        assert j_epoch >= 2, f"chain stopped justifying after node loss ({j_epoch})"
    finally:
        sim.shutdown()
