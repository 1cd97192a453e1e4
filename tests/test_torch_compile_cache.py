"""The port's standard-bucket warmup at boot (``ops/compile_cache.py``),
case by case as the warmup cases of the JAX package's
``tests/test_compile_cache.py``: the bucket list's parsing, the warmup off
by default, its background thread, its records fed to the telemetry
mirror (so ``GET /lighthouse/device`` lists the warmed bucket before the
first batch).  A warm bucket is one supervised neutral ``bls_verify``
dispatch; here on ``device="cpu"`` (the kernels' plain versions) at a
1 x 1 bucket.  Plus ``bn --aot-warmup`` against the JAX package's parser.
"""

import threading

import pytest
import torch

pytest.importorskip("jax")

from lighthouse_tpu import cli as jcli  # noqa: E402
from lighthouse_tpu.ops import compile_cache as jcc  # noqa: E402
from lighthouse_tpu_torch import cli, device_supervisor, device_telemetry, metrics  # noqa: E402
from lighthouse_tpu_torch.ops import compile_cache as cc  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Pin torch's CPU ops to one thread, as every port test file does."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cpu_warmups():
    device_telemetry.reset_for_tests()
    cc.configure(device="cpu")
    yield
    cc.reset_for_tests()
    device_telemetry.reset_for_tests()
    device_supervisor.reset_for_tests()


def _warmups(shape: str) -> float:
    return sum(metrics.DEVICE_AOT_WARMUP.get(op="bls_verify", shape=shape, outcome=o)
               for o in ("hit", "miss"))


def test_constants_match_jax():
    assert (cc.AOT_WARMUP_ENV, cc.AOT_BUCKETS_ENV) == (jcc.AOT_WARMUP_ENV, jcc.AOT_BUCKETS_ENV)
    assert cc.DEFAULT_WARMUP_BUCKETS == jcc.DEFAULT_WARMUP_BUCKETS == ((128, 32), (4096, 32))


@pytest.mark.parametrize("raw,want", [
    ("128x32, 4096x32", [(128, 32), (4096, 32)]), ("", None), ("2X1,,", [(2, 1)]),
    (" , ", None)])
def test_env_bucket_list_parsing(monkeypatch, raw, want):
    monkeypatch.setenv(cc.AOT_BUCKETS_ENV, raw)
    assert cc._env_buckets() == want == jcc._env_buckets()


@pytest.mark.parametrize("raw", ["128by32", "x32", "128x"])
def test_env_bucket_list_rejects_garbage(monkeypatch, raw):
    monkeypatch.setenv(cc.AOT_BUCKETS_ENV, raw)
    with pytest.raises(ValueError, match=cc.AOT_BUCKETS_ENV):
        cc._env_buckets()
    with pytest.raises(ValueError):
        jcc._env_buckets()


def test_warmup_dispatches_bucket_and_feeds_telemetry():
    """One neutral verify at 1 x 1: outcome ``miss`` (the bucket's first
    dispatch), the mirror entry a warmup with no invocation yet, listed in
    the device summary, the warmup counter moved; a second warmup of the
    warm bucket is a ``hit``; the bucket's first production dispatch is not
    counted as its first."""
    before = _warmups("1x1")
    (rec,) = cc.warmup_standard_buckets([(1, 1)])
    assert (rec["op"], rec["shape"], rec["outcome"], rec["device"]) == (
        "bls_verify", "1x1", "miss", "cpu")
    assert rec["seconds"] > 0
    assert device_telemetry.COMPILE_CACHE.seen("bls_verify", (1, 1))
    entry = next(e for e in device_telemetry.summary()["programs"] if e["shape"] == "1x1")
    assert entry["source"] == "warmup" and entry["invocations"] == 0
    assert _warmups("1x1") == before + 1
    (again,) = cc.warmup_standard_buckets([(1, 1)])
    assert again["outcome"] == "hit"
    compiles = metrics.DEVICE_PROGRAM_COMPILES.get(op="bls_verify", shape="1x1")
    assert device_telemetry.note_dispatch("bls_verify", (1, 1), 0.001) is False
    assert metrics.DEVICE_PROGRAM_COMPILES.get(op="bls_verify", shape="1x1") == compiles


def test_warmup_error_is_recorded_off_the_card(monkeypatch):
    """Off the card a failing warmup is an ``error`` record and the next
    bucket is still warmed; nothing is noted for the failed bucket."""
    def broken(nb, device, keys=32):
        raise RuntimeError("neutral batch refused")

    monkeypatch.setitem(cc._NEUTRAL, "bls_verify", ("bls_verify", broken))
    first, second = cc.warmup_standard_buckets([(1, 1), (2, 1)])
    assert first["outcome"] == second["outcome"] == "error"
    assert "neutral batch refused" in first["error"]
    assert not device_telemetry.COMPILE_CACHE.seen("bls_verify", (1, 1))


def test_bad_bucket_list_warms_the_defaults(monkeypatch):
    monkeypatch.setenv(cc.AOT_BUCKETS_ENV, "garbage")
    monkeypatch.setattr(cc, "DEFAULT_WARMUP_BUCKETS", ((1, 1),))
    (rec,) = cc.warmup_standard_buckets()
    assert (rec["shape"], rec["outcome"]) == ("1x1", "miss")


def test_maybe_warmup_from_env_disabled_by_default(monkeypatch):
    monkeypatch.delenv(cc.AOT_WARMUP_ENV, raising=False)
    assert cc.maybe_warmup_from_env() is None
    monkeypatch.setenv(cc.AOT_WARMUP_ENV, "0")
    assert cc.maybe_warmup_from_env() is None
    assert not device_telemetry.COMPILE_CACHE.inventory()


def test_maybe_warmup_from_env_background(monkeypatch):
    monkeypatch.setenv(cc.AOT_WARMUP_ENV, "1")
    monkeypatch.setenv(cc.AOT_BUCKETS_ENV, "1x1")
    thread = cc.maybe_warmup_from_env()
    assert isinstance(thread, threading.Thread) and thread.name == "aot-warmup"
    thread.join(timeout=300)
    assert not thread.is_alive()
    assert device_telemetry.COMPILE_CACHE.seen("bls_verify", (1, 1))


def test_maybe_warmup_from_env_inline(monkeypatch):
    monkeypatch.setenv(cc.AOT_WARMUP_ENV, "yes")
    monkeypatch.setenv(cc.AOT_BUCKETS_ENV, "1x1")
    assert cc.maybe_warmup_from_env(background=False) is None
    assert device_telemetry.COMPILE_CACHE.seen("bls_verify", (1, 1))


def test_bn_aot_warmup_parses_as_the_jax_cli():
    argv = ["bn", "--aot-warmup", "--interop-validators", "8"]
    ours, theirs = cli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    assert ours.aot_warmup is theirs.aot_warmup is True
    assert cli.build_parser().parse_args(["bn"]).aot_warmup is False
