"""Lock-ownership registry: which lock guards which shared mutable state.

The port's counterpart of ``lighthouse_tpu/lock_ownership.py``, written
from the port's own classes: one entry per lock in the concurrent
subsystems, naming the attributes (instance attributes for class locks,
module globals for module-level locks) that must only be written while
that lock is held.  Where the port differs from the JAX package the
entry follows the port: the mesh's per-member CUDA streams
(``MeshState._streams``) in place of the JAX mesh object, autotune's
measured walk lookahead (``Controller._walk_decision``, the walk cache's
memo ``_WALK_MEMO``) in place of the XLA budget cache and the Fq-lowering
choice, and no ``ShardedEntry`` cache lock (the port compiles nothing).

Consumed by the runtime lock sanitizer
(``lighthouse_tpu_torch/locksmith.py``), which installs write guards when
``LIGHTHOUSE_TPU_LOCK_SANITIZE=1``: a write to a registered attribute of a
``guard()``-ed instance while the owning sanitized lock is NOT held by the
writing thread becomes a test failure.  ``tests/test_torch_locksmith.py``
parses this file and checks that every file, class, lock and attribute it
names exists in the port's source: an entry naming an attribute the port
lacks would make ``guard`` protect nothing.

Keys are repo-relative paths; per file, ``classes`` maps
``ClassName -> {lock_attr: [guarded instance attrs]}`` and ``module``
maps ``LOCK_GLOBAL -> [guarded module globals]``.  This module stays a
plain dict literal with no imports, so tools can read it with
``ast.literal_eval``.

Registration discipline: register the attributes a lock's docstring or
comments claim it guards AND that every write site honours.  Attributes
written lock-free on purpose (single-writer counters read by monitoring,
fast-path flags like ``fault_injection.ACTIVE``) stay out of the registry.
"""

#: lock -> guarded-state contract per concurrent module (see the module
#: docstring).
LOCK_OWNERSHIP = {
    "lighthouse_tpu_torch/device_supervisor.py": {
        "classes": {
            "CircuitBreaker": {
                "_lock": [
                    "_state",
                    "_consecutive_failures",
                    "_opened_at",
                    "_probe_successes",
                    "trips_total",
                    "probes_total",
                    "last_failure",
                ],
            },
            "DeviceSupervisor": {
                "_lock": ["_breakers", "_workers", "_deadlines", "_config"],
            },
        },
        "module": {},
    },
    "lighthouse_tpu_torch/device_pipeline.py": {
        "classes": {
            "DeviceArbiter": {
                # _lock is the dispatch slot itself (a gate, not a guard):
                # registered with no guarded attributes so that it is
                # accounted for.
                "_lock": [],
                "_stats": ["_grants", "_wait_s", "_holder"],
            },
            # batches_total and the busy-second counters are single-writer
            # state (the one executor or worker thread), read lock-free by
            # summary(): not registered.
            "DevicePipeline": {
                "_cond": [
                    "_pending",
                    "_pending_sets",
                    "_in_flight_groups",
                    "_shutdown",
                    "groups_total",
                    "sets_total",
                ],
            },
            "HashPipeline": {
                "_cond": [
                    "_pending",
                    "_pending_blocks",
                    "_in_flight_groups",
                    "_shutdown",
                    "groups_total",
                    "blocks_total",
                ],
            },
            "JobPipeline": {
                "_lock": ["_pending", "_shutdown", "jobs_total"],
            },
        },
        "module": {
            "_LOCK": ["_PIPELINE", "_HASH_PIPELINE", "_JOB_PIPELINES"],
        },
    },
    "lighthouse_tpu_torch/device_mesh.py": {
        "classes": {
            "MeshState": {
                "_lock": [
                    "_configured",
                    "_devices",
                    "_full_size",
                    "_generation",
                    "_reshards_total",
                    "_breakers",
                    "_threshold",
                    "_streams",
                ],
            },
        },
        "module": {},
    },
    "lighthouse_tpu_torch/blackbox.py": {
        "classes": {
            "Journal": {
                "_lock": ["_buf", "_seq"],
            },
        },
        "module": {
            "_SNAPSHOTTERS_LOCK": ["_SNAPSHOTTERS"],
            "_CAPTURE_LOCK": ["_CAPTURE_SEQ", "_INDEX"],
        },
    },
    # Node-scoped telemetry: the scope's Lamport clock and worker-deferred
    # event buffer are written from processor worker threads and drained
    # on the runner; the registry lock guards the node-id -> scope map.
    # The flight/log tail deques are single-writer monitoring mirrors.
    "lighthouse_tpu_torch/telemetry_scope.py": {
        "classes": {
            "TelemetryScope": {
                "_lock": ["_lamport", "_pending"],
            },
        },
        "module": {
            "_SCOPES_LOCK": ["_SCOPES"],
        },
    },
    "lighthouse_tpu_torch/autotune.py": {
        "classes": {
            "Controller": {
                "_lock": [
                    "evaluations",
                    "_decisions",
                    "_decision_seq",
                    "_pin",
                    "_pin_applied",
                    "_pin_loaded_env",
                    "_warmups",
                    "_walk_decision",
                ],
            },
        },
        "module": {
            "_MODE_LOCK": ["_MODE"],
            "_OVERLAY_LOCK": ["_OVERLAY", "_MERGED"],
            "_WALK_MEMO_LOCK": ["_WALK_MEMO"],
            "_THREAD_LOCK": ["_THREAD", "_THREAD_STOP"],
        },
    },
    "lighthouse_tpu_torch/fault_injection.py": {
        "classes": {
            "FaultRegistry": {
                "_lock": ["_plans", "_next_id"],
            },
        },
        "module": {},
    },
    "lighthouse_tpu_torch/scheduler/processor.py": {
        "classes": {
            "BeaconProcessor": {
                "_lock": ["_queues", "_active_workers", "_shutdown"],
            },
            "ReprocessQueue": {
                "_lock": [
                    "_by_time",
                    "_awaiting_root",
                    "_seq",
                    "_n_awaiting",
                    "_shutdown",
                ],
            },
        },
        "module": {},
    },
    "lighthouse_tpu_torch/scheduler/admission.py": {
        "classes": {
            "AdmissionController": {
                "_lock": ["_inflight", "_ewma", "_done", "shed"],
            },
        },
        "module": {},
    },
    "lighthouse_tpu_torch/http_api/response_cache.py": {
        "classes": {
            "ResponseCache": {
                "_lock": [
                    "_entries",
                    "hits",
                    "misses",
                    "invalidated",
                    "generation",
                ],
            },
        },
        "module": {},
    },
    # Scenario soak: the runner owns no locks (it drives the Hub's fabric
    # and the nodes' own locked subsystems); the empty entry keeps the file
    # listed, so a lock added here later must be registered.
    "lighthouse_tpu_torch/scenarios.py": {
        "classes": {},
        "module": {},
    },
    "lighthouse_tpu_torch/network/transport.py": {
        "classes": {
            "Hub": {
                "_lock": [
                    "_endpoints",
                    "_links",
                    "_partitions",
                    "_link_plans",
                    "_default_plan",
                    "_link_seq",
                    "_delayed",
                    "_delayed_seq",
                    "_tick",
                    "_counters",
                    "_schedule",
                ],
            },
        },
        "module": {},
    },
}

#: Lock-order edges the runtime sanitizer accepts even though the static
#: graph does not contain them, as ``(first_acquired, then_acquired)``
#: label pairs with a reason.  Cross-object edges are outside the static
#: pass's per-class scope; list here ONLY pairs that are provably acyclic
#: in the wider graph.
SANCTIONED_ORDER_PAIRS = {
    # The arbiter's stats lock nests strictly inside the slot lock and is
    # never held across any other acquisition.
    ("DeviceArbiter._lock", "DeviceArbiter._stats"):
        "leaf stats lock, nests one way inside the slot",
}
