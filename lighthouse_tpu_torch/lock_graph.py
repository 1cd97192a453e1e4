"""Static lock-acquisition graph of the port — generated, not hand-written.

``EDGES`` is ``scripts/analysis/lock_order_pass.acquisition_edges(
repo_root, SCAN_DIRS)`` over the port's paths: every ``(held,
then_acquired)`` lock-label pair the static pass observed.
``lighthouse_tpu_torch/locksmith.py`` cross-checks dynamic acquisition
sequences against this committed graph; ``tests/test_torch_locksmith.py``
fails when the committed tuple drifts from the computed one, so the
runtime sanitizer never proves a stale graph.  Regenerate with::

    python -c "from scripts.analysis import lock_order_pass as p; \\
        from lighthouse_tpu_torch import lock_graph as g; \\
        print(p.acquisition_edges('.', g.SCAN_DIRS))"

This module stays plain literals with no imports.
"""

#: The port's concurrent subsystems the static pass scans: the JAX
#: package's ``lock_order_pass.SCAN_DIRS``, each under the port's package.
SCAN_DIRS = (
    "lighthouse_tpu_torch/chain",
    "lighthouse_tpu_torch/scheduler",
    "lighthouse_tpu_torch/network",
    "lighthouse_tpu_torch/store",
    "lighthouse_tpu_torch/device_supervisor.py",
    "lighthouse_tpu_torch/fault_injection.py",
    "lighthouse_tpu_torch/scenarios.py",
    "lighthouse_tpu_torch/simulator.py",
    "lighthouse_tpu_torch/fork_choice",
    "lighthouse_tpu_torch/device_pipeline.py",
    "lighthouse_tpu_torch/adversary.py",
    "lighthouse_tpu_torch/autotune.py",
    "lighthouse_tpu_torch/ops/shuffle_device.py",
    "lighthouse_tpu_torch/device_mesh.py",
    "lighthouse_tpu_torch/blackbox.py",
    "lighthouse_tpu_torch/telemetry_scope.py",
)

EDGES = (
    ("DeviceArbiter._lock", "DeviceArbiter._stats"),
)
