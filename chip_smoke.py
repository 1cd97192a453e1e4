#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lighthouse_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. card    — the card's name and power limit, as nvidia-smi reports them;
2. build   — nvcc builds csrc/fq_mul.cu, csrc/sha256.cu and csrc/shuffle.cu
             for sm_90a, one process per source started together (times and
             -Xptxas -v);
3. kernels — both Fq kernels against their plain PyTorch versions on the
             card, limb for limb, on canonical, redundant, negative and edge
             inputs at n in KERNEL_NS (block edges of both kernels), with values checked
             against Python integers on a sample;
   hash-kernels — both SHA-256 kernels against their plain versions on the
             card, word for word: sha256_pairs at n in PAIR_NS (up to the
             top bucket, 262,144 blocks, and the edges of its CUDA blocks),
             tree_hash_subtrees at m in SUBTREE_MS (up to 32,768 subtrees,
             a 2^20-leaf level) and on both sides of each step of its
             threads-a-subtree table, through the default entry and at every
             T of ``cuda_sha.SUBTREE_THREADS``; the default entry's digests
             also against hashlib on every row up to 1,000 and on 1,000
             seeded rows above that;
   epoch-kernels — both epoch kernels against their plain versions on the
             card at each registry bucket up to 2^20 and one below it
             (EPOCH_NS): shuffle_round over the mainnet preset's 90 rounds,
             also against the host ``shuffle_list`` up to 65,536 lanes and
             at 2^20; proposer_walk over 32 slots x 64 candidates at its
             default lookahead, against the host ``compute_shuffled_index``
             at every size, and at every lookahead of
             ``cuda_epoch.WALK_LOOKAHEADS`` against its plain version at 63
             and 2^20 with 90 and 10 rounds; shuffle_round's block form (a
             mesh shard's part of a round) at 1,000 and 2^20 - 1,000 live
             lanes against its plain version and the whole round's slice:
             the two halves, a block across the live count and a block of
             padding only, which must pass through;
4. verify  — ``crypto.bls.api.verify_signature_sets`` through the torch
             backend (default device, supervised) at 128 sets x 32 keys (valid -> True,
             one tampered set -> False) and 64 sets x 1 key (-> True); the
             launch counters of both kernels must rise during the 128 x 32 run;
5. parity  — a fixed-seed 4 x 4 batch on the card and on the CPU: the two
             final-exponentiation outputs must be equal limb for limb;
6. kzg     — the vendored mainnet trusted setup (tests/vectors/
             mainnet_trusted_setup.json, 4096 field elements a blob), six
             blobs from a seed committed and proved on the host; then
             ``Kzg(setup).verify_blob_kzg_proof_batch`` at the default device
             on the six (valid -> True, two proofs swapped -> False) and
             ``ops.kzg_device.verify_kzg_proof_batch_device`` on 192 lanes,
             the six tiled 32 times (valid -> True, one y + 1 -> False); the
             launch counters of both kernels must rise in each valid run;
7. kzg parity — a fixed-seed 2-blob batch of the KZG device program on the
             card and on the CPU: ``fe`` equal limb for limb;
8. runtime — the device runtime at full width: ``device_pipeline.enable()``
             on the card, then from ten threads at once one 128 x 32
             block-import group, eight 8 x 1 gossip groups and one 8 x 1
             group with a tampered signature, through
             ``api.verify_signature_sets``; every verdict as expected (only
             the tampered group False), at least one batch of two or more
             groups, no host fallback, breakers closed; the same groups
             again with the pipeline off (each caller's own supervised
             batch), for the wall time beside; then a 6-blob
             ``Kzg.verify_blob_kzg_proof_batch`` under the supervisor with
             the same checks;
9. hash-runtime — both pipelines on the card at once: eight threads each
             bring a 2^18-leaf ``ops.tree_hash.DeviceLeafTree`` to a 1 %-dirty
             version (dirty-path pair batches through the hash pipeline)
             while a ninth verifies one 128 x 32 group through the bls
             pipeline; every root equals ``golden_root``, the verdict is
             True, at least one hash batch coalesced two or more groups,
             the shared arbiter granted both ops, no host fallback;
   mesh   — the device mesh: ``device_mesh.configure("auto")`` over the
             card list gives size 0 (one card: the single-device branch
             production takes); then a mesh of two shards that both name
             ``cuda:0`` (MESH_DEVICES): 127 x 32 and 63 x 1 sets (buckets
             128 x 32 and 64 x 1, padded), each with one tampered set in
             the second shard, through
             ``ops.verify.verify_signature_sets_device`` on the shards
             (False, each shard's fq_mul and fq2_mul launches counted
             apart, the flight record ``128x32@dp2`` with its rows per
             shard) and unsharded from the same host batch: ``fe`` the same
             element of F_p^12;
             the six [kzg] blobs through ``Kzg`` unsharded and on the two
             shards (True, ``8@dp2``; two proofs swapped False); a
             2^16-validator balance list's root and 66,536 pairs on the
             shards, byte for byte the unsharded ones and hashlib's; a
             15 x 1 batch with a dispatch fault charged to shard 1 (split
             retry on the card: both halves True on the shards), then a
             second that trips it: the mesh
             re-shards to size 1 (off), the batch retries single-device,
             True, ``device_mesh_reshards_total`` +1, no host fallback;
             each sharded time beside the unsharded one (no scaling is
             claimed: both shards share the card);
   autotune — ``autotune.measure_walk_lookahead`` on the card: the
             proposer walk (32 x 64 lanes x 90 rounds) at every lookahead,
             each one's time, every output equal and equal to the plain
             version's, the winner cached and ``walk_lookahead()`` now it;
             then, in live mode, on the flight record the earlier phases
             filled plus eight 300-block sha256_pairs batches (bucket
             1,024), one evaluation starts the midpoint 640's warmup (a
             neutral dispatch on the card), the next adopts it (the overlay
             equals what the two evaluations adopted: the earlier phases'
             traffic may qualify another bucket too), a 500-block
             layer dispatches at 640 with hashlib's digests; the decision
             log printed; the mode and vocabularies restored after;
10. state  — BeaconState tree hashing at mainnet width on the default
             device: a Deneb mainnet-preset state of 2^20 validators from a
             seed; its root with ``tree_hash.configure(enabled=True)`` and
             ``install_device_hash()``, then after one slot's changes (1 % of
             balances and 64 effective balances); then a state of 2^16
             validators from the same seed, its full root and its root
             after 16 appended validators (appending resets the registry
             cache, so at 2^20 it would repeat the full root); each root
             equal to the root the host
             engines compute on the native kernel, both kernels launched
             (counts set to 0 just before the first root, read after the
             last), no host fallback, breakers closed; blocks and seconds
             per route (card via the subtree kernel, card via the pair
             kernel, host below a threshold, host above the top bucket),
             host and device seconds apart;
11. epoch  — the epoch boundary at mainnet width on the card: a Deneb
             mainnet-preset state of 2^20 validators one slot before a
             boundary, from a seed (``workload.boundary_state``: ejections,
             the activation queue, pending activations, slashed
             validators); the staged ``epoch_deltas_device`` once on its
             registry against the numpy pass; then it crosses the boundary
             through ``per_slot.process_slots``
             with the fused boundary on the card, out of an inactivity
             leak, and a state of 2^16 validators from the same seed
             (EPOCH_LEAK_VALIDATORS) crosses it in one; each result equals
             a numpy-backend run of the port on the state itself (the card
             runs on a copy) in balances, inactivity,
             validator fields, committees, proposers and state root, with
             no host fallback; host seconds, device seconds (flight record)
             and the kernels' launches (counts set to 0 just before the
             first boundary, read after the last; both kernels must have
             run); then the epoch programs split across the device mesh:
             the two boundaries' plans (no new state) through
             ``epoch_boundary_device`` and ``epoch_deltas_device``
             unsharded on the card and on a mesh of MESH_DEVICES (two
             shards of the card), every output of the split equal to the
             unsharded run's and numpy's, the flight records ``mesh`` 2
             with ``shard_live`` summing to the registry, shuffle_round
             launched 90 times by each shard (counts set to 0 just before
             the split boundary), the walk once on the first member; the
             seconds of each run and the exchange's bytes as the split
             shuffle counts them where it copies and gathers; the mesh off
             again;
12. block  — block import at mainnet width on the default device: a Deneb
             mainnet-preset state of 2^20 validators at the first slot of
             an epoch and the full block a mainnet proposer packs for the
             next slot, every signature real, from a seed
             (``workload.block_import_case``: 128 attestations of the 64
             committees of the previous slot, a 95 % sync aggregate, a
             proposer and an attester slashing, an exit, a BLS change, 16
             withdrawals, 300 transactions, 6 blob commitments; the
             block's state root from a host run without verification); the
             port's pubkey cache warmed with the block's keys and the
             state's hash cache with one full root, both before the import
             and printed; then ``state_transition`` with ``VERIFY_BULK``:
             the block's signatures in one supervised bls_verify batch on
             the card (its bucket and stages from the flight record, no
             host fallback, breakers closed), the post-state equal to the
             host run's (root, balances, participation, validators, SSZ
             bytes), all four kernels launched (counts set to 0 just before
             the import, read just after); host seconds split into
             process_slots, signature-set collection, the verify's setup,
             the operations and the root; fork choice anchored at the
             pre-state takes the block and its attestations, its head is
             the block and the anchor's weight the attesters' effective
             balances; a copy of the pre-state refuses the block with two
             attestation signatures swapped (``BlockProcessingError``, the
             batch's verdict False on the card) and with its state root
             off by one byte (``StateRootMismatch``); the case is built
             once, its block carrying the six [kzg] commitments, and
             shared with [chain];
13. chain  — a checkpoint-synced node at mainnet width on the default
             device: ``BeaconChain`` anchored at a copy of the [block]
             case's pre-state (hash cache warmed by one full root) over
             ``HotColdDB(hot=LockboxStore(<tmp>/chain.db))``, a
             ``ManualSlotClock`` at the block's slot, the [kzg] ``Kzg`` and
             an ``ExecutionLayer`` speaking the Engine API over HTTP with
             JWT to a ``MockEngineServer`` (the anchor's root, store write
             and fork-choice anchor timed apart); the sidecars' header
             signature checked on the card (another signature refused);
             then [wire] and [network] on this node; then
             ``process_block_with_blobs`` of the block and its six
             sidecars (``workload.blob_sidecars``): one supervised
             kzg_batch and one supervised bls_verify batch on the card, no
             host fallback, breakers closed, all four BLS and hash kernels
             launched (counts set to 0 just before the import, read just
             after), exactly one ``engine_newPayloadV3`` to the mock engine
             carrying the six sidecars' versioned hashes and the parent
             root, and a ``forkchoiceUpdated`` after it (its
             ``notify_new_payload`` timed), the head the block, the
             post-state equal to the host run's (root, balances,
             participation, SSZ bytes), get_blobs the six sidecars; the
             import's spans (da_check,
             state_transition, fork_choice, store_write, head_recompute)
             and ``parent_state.copy()`` timed apart; the state's sync
             committee signs the head (512 messages): all accepted by one
             512 x 1 batch on the card, and 4 messages with one foreign
             signature give exactly one error (the batch, then 4 single
             verifies, on the card); refused, the head, the store's key
             count and the block caches unchanged: a copy of the block
             whose sidecar 3 carries sidecar 4's proof (the kzg_batch
             False on the card); then [http], [vc] and [client] on this node; a
             fresh ``HotColdDB`` on the same file reads back the block
             byte for byte, the post-state's stored SSZ bytes (those of
             [http]'s download) and its summary;
    wire   — [chain]'s node on the wire before its import (slot S-1's
             gossip arrives before block S): a ``LocalNode`` on a secured
             ``TcpEndpoint`` on 127.0.0.1 (four processor workers, the
             slasher on with a 64-epoch history, the default BLS backend)
             with discv5 on under its Noise identity key, and a second
             peer, pub, a ``NetworkService`` on its own secured
             ``TcpEndpoint`` with its own ``Discv5Service``, on the 64
             attestation subnets, the aggregate topic and the
             attester-slashing topic.  pub bootstraps from the node's ENR,
             reads the node's record as the node serves it (its signature
             verifies; its ip/tcp are the node's listener, its key the
             node's Noise identity) and dials it: multistream-select, Noise
             XX with the secp256k1 identity proof (each side's proven key
             the other's ENR key), yamux, ``/meshsub/1.1.0``; then each
             side's mesh holds the other on every topic.  pub publishes,
             as snappy SSZ on their topics, while the node's workers are
             held: 1,024 unaggregated attestations of the anchor's slot (16
             members of each of its 64 committees, each signed with its
             own key; cut from 4,096, then 2,048, for the time limit), then
             64 aggregates (one a committee over its 16 attesters, its
             aggregator the first member in key order whose selection
             proof passes ``is_aggregator``); each drains through the
             router's batch handler as one batch and one supervised
             bls_verify batch on the card (1,024 sets; 192 sets); the
             node's service received exactly
             the messages pub sent (in order, by topic and message id);
             every vote and aggregate applied, every aggregator observed,
             no host fallback, nothing dropped, nothing forwarded back to
             pub, no slashing; each batch's items, sets, bucket, queue
             wait, preverify, setup, dispatch, wait, apply, slasher
             seconds and Fq launches (counts set to 0 just before the
             first publish, read after the aggregates' drain); pub's send
             and the node's receipt seconds; the wire's own seconds: the
             discv5 lookup, each step of the handshake ladder on both
             ends, the native cipher's seal and open calls, yamux's and
             meshsub's framing;
    network — then the same over a seeded in-process ``Hub``, cut to 64
             attestations (the next member of each committee after
             [wire]'s 16) and 64 aggregates over them (each committee's
             second aggregator in key order: a node observes one aggregate
             an aggregator and epoch), with the same gates (64 sets; 192
             sets); then 8 more,
             one under another member's signature: one batch False on the
             card, 8 single verifies, exactly one ``bad_signature``
             rejection of pub; after the import (with the sync batch and
             the refusals), a double vote: a validator of slot S+1 with a
             key votes for the block, then for the anchor, with one
             target: the first applied, the second verified and fed to the
             slasher only, which finds the one double vote; the router
             verifies the ``AttesterSlashing`` on the card, pools it and
             publishes it to pub, its bytes those of the port's slasher on
             the CPU; the slasher's seconds and array bytes, the peak RSS;
    http   — then the Beacon API on [chain]'s node: ``HttpApiServer``
             (a ``BeaconProcessor`` of two workers, the response cache on)
             on 127.0.0.1, read by ``BeaconNodeHttpClient`` over a socket:
             the node's version, syncing and health,
             ``/lighthouse/autotune`` (200: the controller's snapshot with
             [autotune]'s measured lookahead, the admission state),
             genesis, the head state's root and finality checkpoints, 4
             validators, 64
             balances, the 64 committees of the head's slot, 64 attester
             duties of its epoch and 64 attestation rewards of the epoch
             before (against ``rewards.attestation_rewards`` called on the
             head state), the head's header, its block as SSZ byte for
             byte, its six blob sidecars, and the checkpoint-sync download
             of the head state as SSZ (148.6 MB), byte for byte the host
             run's post-state; the root, the committees and the duties
             asked twice, each second answer a cache hit (byte for byte,
             no handler run), the arbiter's ``http_api`` grants equal to
             the misses; then three attestations of the head's slot, one
             from each of three committees, the last under another
             member's signature, POSTed to the pool: HTTP 400 naming index
             2 only, three single-set supervised bls_verify batches on the
             card (two True, then False), both Fq kernels launched, the
             two good ones published and pooled, and
             ``/lighthouse/device/batches`` listing the three records;
             beside the POST, ``POST /lighthouse/device/profile?seconds=3``:
             200, its trace naming ``fq_mul_kernel``; each request's seconds
             on the client and in ``http_api_request_seconds``; the server's
             task spawner waits HTTP_TIMEOUT_S for a handler (its default
             30 s cannot cover a duty poll at 2^20);
    vc     — then, on the same server and the same node, a validator
             client: the first 8 keyed, unslashed members of the
             committees of slot S+2 (the head is S+1) not yet seen
             attesting in the epoch (the double vote's validator is one
             of S+2's), written as EIP-2335
             keystores (``crypto.keystore.encrypt`` at its defaults,
             scrypt n = 2^18) and imported over HTTP through
             ``KeymanagerServer`` into the client's empty
             ``ValidatorStore``, ``GET /eth/v1/keystores`` listing the 8;
             the two official EIP-2335 vectors decrypt to their secrets;
             the node's clock to S+2, then ``ValidatorClient.run_slot(S+2)``
             with one ``BeaconNodeHttpClient`` (timeout HTTP_TIMEOUT_S) and
             an EIP-3076 database on a lockbox file: its attester duties of
             epochs E and E+1, proposer duties of E and sync duties equal
             the head state's committees, proposers and sync committee;
             its summary proposes nothing, attests 8 times and sends one
             sync message per sync duty; the pool at S+2 holds the 8 votes
             byte for byte as the client signed them; on the card 8
             single-set bls_verify batches, one sync batch, one three-set
             batch for each aggregate and one for the contributions the
             client was elected to publish, every verdict True, no host
             fallback, both Fq kernels launched (counts set to 0 just
             before ``run_slot``, read just after); a second vote at S+2
             for another head refused by the client's database
             (``SlashingProtectionError``, nothing POSTed), the database's
             interchange export listing the 8 votes; printed: each call's
             seconds on the client (split into ``state.copy`` and
             ``process_slots``) and each route's in
             ``http_api_request_seconds``, the host's signing seconds, the
             KDF seconds, the verifies' stages and
             ``http_requests_shed_total``;
    client — beside [vc], in a second process, the node an operator
             starts: [http]'s download of the post-state written beside a
             devnet ``config.yaml`` (mainnet, every fork up to Deneb at
             epoch 0), then ``python -m lighthouse_tpu_torch bn
             --testnet-dir D --genesis-state D/state.ssz --datadir D/db
             --http-port 0 --listen-port 0 --peers <host:port>`` on the
             card (no ``--device``; ``--aot-warmup`` with
             ``LIGHTHOUSE_TPU_AOT_BUCKETS=128x32``;
             ``LIGHTHOUSE_TPU_MESH=auto``,
             ``LIGHTHOUSE_TPU_AUTOTUNE=pinned``), its peer a ``LocalNode``
             of [chain]'s
             node on a ``TcpEndpoint`` (the builder's endpoint is
             unsecured, as the JAX package's, so it cannot dial [wire]'s);
             its gates run from a thread while [vc] runs: ``beacon node
             up`` in its log, its pid in ``nvidia-smi
             --query-compute-apps``; its head root, state root and
             finality checkpoints [chain]'s and [http]'s, its sync
             distance the wall clock's, its ``/lighthouse/device`` mesh
             section size 0 (disabled, one card) and autotune mode pinned,
             its ``programs`` listing the 128 x 32 bucket as a warmup
             (outcome hit or miss, no failed warmup in its log; its
             seconds, and the first POST's extra device seconds, logged)
             (its header route 404: the anchor
             has no signed block, as in the JAX package); [network]'s
             double-vote slashing POSTed with attestation_1 under
             attestation_2's signature (HTTP 400, bad signature), then as
             it is (200) and read back from its pool as sent, its flight
             record two 2-set bls_verify batches [False, True] and the
             boot root's tree_hash batches, no host fallback, breakers
             closed; its kernel launches (its ``/metrics``, from 0 at its
             start): the subtree kernel at boot, both Fq kernels for the
             POSTs; one peer counted, [chain]'s node listing it; no
             ``beacon_state_advance_seconds`` observation; its RSS; SIGTERM
             gives exit code 0 within CLIENT_STOP_S (else its log's tail
             is printed and it is killed); printed: the time to ``beacon
             node up``, the boot split from its log (decode, the kernel
             libraries, the anchor's root, the chain's store write and
             fork-choice anchor), each request's seconds on the client
             and in its ``http_api_request_seconds``, both verifies'
             stages and the POSTs' rest (the head-state copy);
14. chain-harness — the SURVEY §7 harness (minimal preset, 64 interop
             validators), real crypto on the default device: a
             ``ValidatorClient`` with the 64 interop keys, over HTTP to an
             ``HttpApiServer`` on the chain, runs its first slot: it
             proposes (its block the head, imported with one bulk batch on
             the card), attests, sends sync messages, aggregates (every
             duty at this committee size) and publishes contributions,
             each count equal to the slot's duties and every batch True
             on the card, no host fallback; the same slot on the fake
             backend against a replay harness gives the same block and
             state roots; a second block at the slot is refused by the
             client's slashing protection; at the next slot a block under
             another signature, an attestation by another validator and
             the block with two of the client's attestations under each
             other's signatures (the chain unchanged) refused by verdicts
             on the card; then 40 fake-crypto slots on a HotColdDB over a lockbox
             file: justified epoch >= 4, finalized >= 3, the hot->cold
             migration (a cold state equal to the chain's), each boundary's
             fused program on the card and both epoch kernels launched,
             every block and state root equal to a run on the CPU path
             (numpy epoch backend, host tree hashing), and the reopened
             file's head block and finalized checkpoint the chain's; then,
             real crypto on the card, the builder path (a ``MockRelay``
             over HTTP, its key pinned: ``produce_blinded_block`` verifies
             the bid on the card, the proposer signs, ``unblind_and_import``
             imports the revealed block on the card; a reveal for a header
             changed after the bid refused with ``BlockError``) and the
             eth1 path (one deposit from a provider through
             ``Eth1Service`` and its ``DepositCache`` into the produced
             block, imported on the card, the registry one longer), each
             root and the refusal equal to the CPU path's;
    soak   — the soak tooling (``lighthouse_tpu_torch.scenarios``):
             ``smoke_partition``'s fleet (3 nodes, 16 validators, fake
             crypto), its 38 slots and partition/heal, with an
             ``epoch_device`` event (the fused boundary) and a
             ``state_hashing`` event (pair layers of 4+ blocks through
             ``tree_hash.hash_pairs``) at the window's first slot, run with
             ``device="cuda"``, its objects built on the lock sanitizer's
             locks (``LIGHTHOUSE_TPU_LOCK_SANITIZE=1`` set just before the
             run; ``locksmith.check()`` after it finds no violation, the
             locks built and acquisitions checked logged): its
             convergence and finality gates pass,
             every flight record of the run (``sha256_pairs`` and
             ``epoch_boundary`` among them) is off the host and no
             fallback counter rises, ``sha256_pairs``, ``shuffle_round``,
             ``proposer_walk`` and the fused program launched (counts set
             to 0 just before the run, read just after); then
             ``fused_epoch_boundary`` with ``device="cuda"``: its injected
             ``epoch_boundary`` error raises instead of reaching the host,
             the run ends at the window's first boundary (``RequeueWork``
             from the breaker its faults opened), the numpy composite
             never answers, its SOAK artifact names the failure and a
             postmortem bundle, the routes are back and the next
             4,096-validator boundary on the card equals the numpy run;
             last, the card run's head root and per-slot timeline equal
             those of a child process started with the script (no card):
             the same scenario with ``device="cpu"`` (the kernels' plain
             versions, several minutes) and ``smoke_partition`` on the
             host routes;
15. faults — the supervisor's routes on the card at small size, each with
             its exact counter deltas and none with a host fallback (on
             the card a failure raises into the caller): a
             ``device.dispatch`` error on a 4-set batch (split retry, both
             halves on the card), a hang past a short deadline (watchdog,
             ``DispatchTimeout`` raised), errors up to the breaker
             threshold (each raised; OPEN, then ``RequeueWork`` raised
             without a launch, then HALF_OPEN probes on the card back to
             CLOSED), a ``corrupt`` verdict, and a ``kzg_batch`` dispatch
             error on 2 blobs (no split, the error raised); on the hashing
             ops, a ``device.dispatch`` error on sha256_pairs and on
             tree_hash (split retry, both halves on the card, bytes equal to
             the golden), a hang on tree_hash (``DispatchTimeout`` raised),
             and an error on every sha256_pairs dispatch under the hash
             pipeline (both groups' futures raise, nothing re-hashed on the
             host); and an ``epoch_boundary`` dispatch error on a 4,096-
             validator boundary (no split, raised, the numpy composite never
             runs); a ``device.dispatch`` error on the verify batch of a
             4,096-validator block import (split retry, both halves on the
             card, the block imports with its root); the processor's
             requeue: the bls_verify breaker opened by a fault plan, then 8
             gossip attestations through a ``LocalNode``'s processor into
             its router's batch handler: the batch's
             ``RequeueWork``, each event requeued once
             (``beacon_processor_work_requeued_total`` +8), the retry the
             HALF_OPEN probe on the card, all applied, none dropped;
16. timing — each kernel and its plain version at the largest shape the
             128 x 32 run gave it, beside the least time the card could take;
             then each kernel at every launch size of that run (the
             histogram ``cuda_fq.SIZES``; a size timed once whichever runs
             gave it), summed to its time per verify,
             beside its bound per verify, and likewise per 6-blob and per
             192-lane KZG batch, per [block] import and per [wire] and
             [network] drain; each SHA-256
             kernel at its top bucket and at every launch size of the [state] run
             and of the [block] import, beside its bound and
             plain version, its launches per state root, and the native
             host pair hasher's rate; the subtree kernel at every T at each
             [state] size, in turns, and summed over the run's launches;
             each epoch kernel at its [epoch] launch (a round of the 2^20
             shuffle; the 32 x 64-lane walk) beside its bound and plain
             version, the walk at every lookahead and alone on one lane
             (its latency floor), in turns; the redesigned kernels' log
             lines beside their earlier designs' times as PERF.md records
             them (EARLIER_MS, not measured here); the two epoch PyTorch
             programs (deltas, the fused boundary) at 2^20, the boundary
             also on the kernels' plain versions and once under
             torch.profiler.  Kernel times are device times of
             launches replayed from a CUDA graph, so the host's launch
             overhead does not count.

Every verify, KZG, hash and epoch batch of phases 4, 6 and 8 to 14 (and
[soak]) runs through the device supervisor (``device_supervisor.py``); the script fails
if any of them took the host route or left a breaker open.  Per-batch stages come from
the flight recorder (``device_telemetry``).

Each phase (and [wire], [network], the double vote, [http], [vc] and
[client] inside [chain])
prints ``[phase] <name> <seconds> s``, its wall time.  The line before the
last is one JSON object naming every kernel with its numbers; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA,
or outside the repository, the script exits non-zero and prints no result.
It needs no network and leaves no process running ([client]'s node is
stopped, or killed when a gate fails).
"""

from __future__ import annotations

import contextlib
import gc
import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

#: H100 SXM memory rate (bytes/s).  The operations per product and the
#: card's IMAD rate are in lighthouse_tpu_torch/bench_kernels.py.
HBM_BYTES_PER_S = 3.35e12
#: Bytes one row moves (two operands in, one result out), per kernel.
KERNELS = {
    "fq_mul": {"bytes": 3 * 25 * 4, "replaces": "lighthouse_tpu/ops/pallas_fq.py:122"},
    "fq2_mul": {"bytes": 3 * 2 * 25 * 4, "replaces": "lighthouse_tpu/ops/pallas_fq.py:131"},
}
SOURCE = "lighthouse_tpu_torch/csrc/fq_mul.cu"
#: Kernel check sizes; the main path's (sets, keys); the gossip batch.
KERNEL_NS = (1, 3, 5, 7, 15, 17, 127, 128, 129, 65536)
MAIN = (128, 32)
GOSSIP = (64, 1)
#: KZG: blobs per block (MAX_BLOBS_PER_BLOCK of the mainnet Deneb preset),
#: lanes of the Deneb target (6 blobs x 32 blocks), the trusted setup.
KZG_BLOBS = 6
KZG_LANES = 192
KZG_SETUP = Path(__file__).resolve().parent / "tests" / "vectors" / "mainnet_trusted_setup.json"
#: Runtime phase: the pipeline's pinned linger (s).  Fault phase: the short
#: watchdog deadline of the hang case and the injected hang (s).
RUNTIME_LINGER_S = 0.1
HANG_DEADLINE_S = 3.0
HANG_SLEEP_S = 6.0
#: The hashing slice's two kernels: bytes one row moves (a 64-byte block in
#: and its 32-byte digest out; a subtree's 32 leaves in and its 31 interior
#: nodes out) and the integer operations one row needs (csrc/sha256.cu: a
#: round is 14 operations, a message schedule step 10, the padding block's
#: schedule is constant: 64 x 14 + 48 x 10 + 8 + 64 x 14 + 8 a block).
SHA_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 64 * 14 + 8
SHA_KERNELS = {
    "sha256_pairs": {"bytes": 64 + 32, "ops": SHA_OPS_PER_BLOCK,
                     "replaces": "lighthouse_tpu/ops/sha256_device.py:135"},
    "tree_hash_subtrees": {"bytes": 32 * 32 + 31 * 32, "ops": 31 * SHA_OPS_PER_BLOCK,
                           "replaces": "lighthouse_tpu/ops/tree_hash.py:176"},
}
SHA_SOURCE = "lighthouse_tpu_torch/csrc/sha256.cu"
#: The card's 32-bit integer issue rate: 64 operations per clock per SM.
INT_OPS_PER_CLK_PER_SM = 64
SMS = 132
#: [hash-kernels] sizes: the pair kernel's block counts (its top bucket and
#: the edges of its 256-thread CUDA blocks) and the subtree kernel's subtree
#: counts (its top bucket, a 2^20-leaf level, the edges of its 8-subtree
#: CUDA blocks at T = 16, and both sides of each step of its T table, which
#: steps at the caller's buckets 128 and 2,048); hashlib checks every row
#: up to HASHLIB_ALL rows and HASHLIB_ALL seeded rows above that.
PAIR_NS = (1, 31, 255, 256, 257, 511, 512, 513, 1000, 65536, 262144)
SUBTREE_MS = (1, 3, 7, 8, 9, 15, 16, 17, 128, 129, 2048, 2049, 32768)
HASHLIB_ALL = 1000
#: The earlier designs' times of the subtree kernel (16 threads a subtree,
#: a level at a time) and the walk (one thread a lane, a round a step), as
#: PERF.md §6 records them (a chip_smoke.py run on an NVIDIA H100 80GB HBM3,
#: 700.00 W): printed in the [timing] log beside this run's times, and in
#: no result, since this run does not measure them.  The subtree kernel at
#: each [state] launch size and over the [state] run's 34 launches, the
#: walk at 32 x 64 lanes x 90 rounds.
EARLIER_MS = {
    "tree_hash_subtrees": {"by_size": {8: 0.0148, 128: 0.0152, 2048: 0.0266, 32768: 0.3669},
                           "state": 2.773},
    "proposer_walk": {"ms": 0.1267},
}
#: [state]: validators in the registry (the order of mainnet's, the top of
#: the JAX package's epoch buckets); the slot's changes (the JAX package's
#: bench STATE_DIRTY_FRACTION of the balances, effective balances,
#: deposits); the registry of the deposit step's own state (appending resets
#: the registry cache, as in the JAX package, so at 2^20 the step repeats
#: the full root).
STATE_VALIDATORS = 1 << 20
STATE_DIRTY_FRACTION = 0.01
STATE_EFFECTIVE = 64
STATE_APPENDED = 16
STATE_DEPOSIT_VALIDATORS = 1 << 16
#: [hash-runtime]: threads updating their own tree, leaves a tree, dirty
#: share of an update.
HASH_THREADS = 8
HASH_TREE_LEAVES = 1 << 18
HASH_DIRTY_FRACTION = 0.01
#: The epoch slice's two kernels (csrc/shuffle.cu).  A shuffle round moves
#: 4 bytes in and 4 out a lane plus its digest row (one bit a lane); the
#: proposer walk does one compression a lane a round on a few bytes of seeds
#: and pivots, of which rounds 0-7 and schedule words W16 .. W22 read only
#: the seed and are done once a slot (csrc/sha256_compress.cuh: a round 14
#: operations, a schedule step 10): 56 x 14 + 41 x 10 + 8 a lane a round,
#: 8 x 14 + 7 x 10 a slot.
SHUFFLE_SOURCE = "lighthouse_tpu_torch/csrc/shuffle.cu"
WALK_OPS_PER_ROUND = 56 * 14 + 41 * 10 + 8
WALK_OPS_PER_SLOT = 8 * 14 + 7 * 10
EPOCH_KERNELS = {
    "shuffle_round": {"replaces": "lighthouse_tpu/ops/shuffle_device.py:112"},
    "proposer_walk": {"replaces": "lighthouse_tpu/ops/shuffle_device.py:186"},
}
#: [epoch-kernels] and [epoch]: the mainnet preset's shuffle rounds, slots
#: and proposer candidates; registry sizes checked (each bucket and one
#: below it); the [epoch] registry (the top of the JAX package's epoch
#: buckets, the order of mainnet's) and the [faults] epoch registry.
SHUFFLE_ROUNDS = 90
EPOCH_SLOTS = 32
EPOCH_NS = (1, 2, 63, 64, 255, 256, 1023, 1024, 4095, 4096, 16384, 65536, 262144,
            1048575, 1048576)
EPOCH_HOST_MAX = 65536
#: The walk's rounds checked at every lookahead: the mainnet and minimal
#: presets' shuffle_round_count.
WALK_CHECK_ROUNDS = (90, 10)
#: [epoch]: the no-leak boundary's registry (mainnet's order), the leak
#: boundary's (the same program at a smaller bucket; its own state from the
#: same seed) and the [faults] boundary's.
EPOCH_VALIDATORS = 1 << 20
EPOCH_LEAK_VALIDATORS = 1 << 16
EPOCH_FAULT_VALIDATORS = 4096
#: [epoch-kernels]: shuffle_round's block form (a mesh shard's part of a
#: round) at these live counts, in three rounds of a 90-round table: the
#: two halves, a block across the live count and one of padding only.
SHUFFLE_BLOCK_NS = (1000, (1 << 20) - 1000)
SHUFFLE_BLOCK_ROUNDS = (0, 45, 89)
#: [block]: validators in the registry (mainnet's order), the [faults]
#: block's registry, and the seed both cases are made from.
BLOCK_VALIDATORS = 1 << 20
BLOCK_FAULT_VALIDATORS = 4096
BLOCK_SEED = 0xB10C
#: [chain]: the tampered sync batch's messages (a tampered batch re-runs
#: each message alone, so it stays small).  [chain-harness]: the harness's
#: interop validators, its real-crypto slots and its slots to finality (five
#: minimal-preset epochs).
CHAIN_SYNC_TAMPERED = 4
#: [chain]'s execution engine: the Engine API's JWT secret of the mock
#: engine served over HTTP.
EL_JWT_SECRET = random.Random(0xE1).randbytes(32)
#: [network]: gossip attestations (one STANDARD_DEVICE_BATCH, spread over
#: the slot's committees; one aggregate a committee comes with them), the
#: tampered batch, the slasher's history in epochs (cut from Lighthouse's
#: 4,096: its arrays take 48 bytes a validator and epoch), the hub's seed
#: and the seconds the node may take to drain.
WIRE_ATTESTERS = 16  # [wire]: 1,024 attestations of a 64-committee slot
NET_ATTESTERS = 1  # [network]: 64, one a committee after [wire]'s members
NET_TAMPERED = 8
SLASHER_HISTORY = 64
NET_SEED = 0x6055
NET_IDLE_S = 900.0
#: [http]: the Beacon API on [chain]'s node: the indices of the balance,
#: duty and reward reads (seeded), the attestations POSTed to the pool (one
#: a committee: two good ones, then one under another member's signature;
#: [vc]'s POST of VC_KEYS carries the many-attestation case), the
#: profiler's window and the timeout of the client and of the server's
#: task spawner (a duty poll at 2^20 copies the state).
HTTP_IDS = 64
HTTP_ATTESTERS = 3
HTTP_PROFILE_S = 3
HTTP_SEED = 0x4777
HTTP_TIMEOUT_S = 600.0
#: [vc]: the validator client's keys (keyed, unslashed members of the
#: committees of the slot after the head's that have not attested in the
#: epoch, imported as EIP-2335
#: keystores at the default work factor) and their password.
VC_KEYS = 8
VC_PASSWORD = "chip_smoke validator client"
#: [client]: the seconds the node started through the CLI may take from
#: its start to ``beacon node up`` (decode, root, store write, fork choice
#: at 2^20), and from SIGTERM to its exit; the lines of its log printed
#: when a gate fails.
CLIENT_BOOT_S = 600.0
CLIENT_STOP_S = 30.0
CLIENT_LOG_TAIL = 60
#: [client]: the node starts with ``--aot-warmup`` and warms this bucket
#: list (``LIGHTHOUSE_TPU_AOT_BUCKETS``; the default's 4096 x 32 bucket is
#: left out to keep the boot short); the seconds its record may take to
#: appear after ``beacon node up``.
CLIENT_WARMUP_BUCKETS = "128x32"
CLIENT_WARMUP_S = 300.0
HARNESS_VALIDATORS = 64
HARNESS_SLOTS = 40
#: [chain-harness]'s eth1 path: the interop index of the new depositor;
#: the graffiti of its builder and eth1 blocks.
ETH1_NEW_VALIDATOR = 100
HARNESS_GRAFFITI = b"chip_smoke builder/eth1".ljust(32, b"\x00")
#: [soak]: the seed of its scenarios; the least pair-hash layer (64-byte
#: blocks) its ``state_hashing`` event sends to the card; the seconds the
#: CPU child started with the script (the KZG inputs, [soak]'s reference)
#: may still take once the script reads it.
SOAK_SEED = 0
SOAK_THRESHOLD_BLOCKS = 4
CHILD_WAIT_S = 600.0
#: [timing]: the plain versions of the SHA-256 and epoch rows, timed on one
#: replay of one call after the untimed warm replay (their figures held to
#: three significant figures over PRs 7-13 at two replays).
PLAIN_ONCE = {"reps": 1, "rounds": 1}
#: The supervisor's counters whose deltas each fault case asserts.
SUPERVISOR_COUNTERS = {
    "host_fallbacks": "DEVICE_HOST_FALLBACK",
    "dispatch_timeouts": "DEVICE_DISPATCH_TIMEOUTS",
    "split_retries": "DEVICE_SPLIT_RETRIES",
    "breaker_transitions": "DEVICE_BREAKER_TRANSITIONS",
}


def log(*args) -> None:
    print(*args, flush=True)


@contextlib.contextmanager
def phase_wall(name: str):
    """Print ``[phase] <name> <seconds> s``, the block's wall time, after it
    (also when it raises)."""
    t = time.perf_counter()
    try:
        yield
    finally:
        log(f"[phase] {name} {time.perf_counter() - t:.1f} s")


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs


def rand_values(rng: random.Random, n: int) -> list:
    from lighthouse_tpu_torch.crypto.bls.params import P

    return [rng.getrandbits(384) % P for _ in range(n)]


def limbs(values) -> "torch.Tensor":
    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops.fq import to_limbs16

    return torch.as_tensor(np.stack([to_limbs16(v) for v in values]))


def operand_cases(rng: random.Random, n: int) -> dict:
    """(a, b, value_a, value_b) per input family; values are the integers the
    limb rows stand for (redundant and negative rows included)."""
    from lighthouse_tpu_torch.crypto.bls.params import P

    va, vb = rand_values(rng, n), rand_values(rng, n)
    a, b = limbs(va), limbs(vb)
    edge = [0, 1, P - 1, P - 2]
    ve = [edge[i % 4] for i in range(n)]
    vf = [edge[(i // 4 + 1) % 4] for i in range(n)]
    return {
        "canonical": (a, b, va, vb),
        "redundant": (a * 37 - b * 12, b * 55 - a * 3,
                      [37 * x - 12 * y for x, y in zip(va, vb)],
                      [55 * y - 3 * x for x, y in zip(va, vb)]),
        "negative": (-a, -(b * 3), [-x for x in va], [-3 * y for y in vb]),
        "edge": (limbs(ve), limbs(vf), ve, vf),
    }


def sample_rows(n: int) -> list:
    return sorted({0, n // 2, n - 1} | set(range(min(n, 4))))


# ------------------------------------------------------------------ phases


def phase_build() -> dict:
    from lighthouse_tpu_torch.ops import compile_cache, cuda_build

    t0 = time.perf_counter()
    results = compile_cache.build_kernels(force=True)
    wall = time.perf_counter() - t0
    for name, res in results.items():
        log(f"[build] {name}: nvcc {' '.join(cuda_build.NVCC_FLAGS)}: {res.seconds:.1f} s -> "
            f"{res.path.name}")
        for line in cuda_build.ptxas_summary(res.log):
            log(f"[build] {name}: {line}")
    log(f"[build] {len(results)} sources built at once in {wall:.1f} s")
    return {"seconds": {name: res.seconds for name, res in results.items()}, "wall_s": wall}


def phase_kernels(cuda_fq) -> dict:
    import torch

    from lighthouse_tpu_torch.crypto.bls.params import P
    from lighthouse_tpu_torch.ops.fq import from_limbs16

    rng = random.Random(0x5EED)
    max_err = {"fq_mul": 0, "fq2_mul": 0}
    # Output limb bounds: 2^16.3 for an Fq product; the Fq2 recombination
    # t2 - t0 - t1 adds up to three of them.
    bound = {"fq_mul": 80685, "fq2_mul": 3 * 80685}
    for n in KERNEL_NS:
        for kind, (a, b, va, vb) in operand_cases(rng, n).items():
            a, b = a.cuda(), b.cuda()
            k = cuda_fq.fq_mul(a, b)
            p = cuda_fq.fq_mul_plain(a, b)
            # Fq2 rows: (a, b rolled) x (b, a rolled), values alike.
            a2 = torch.stack([a, b.roll(1, 0)], dim=1).contiguous()
            b2 = torch.stack([b, a.roll(2, 0)], dim=1).contiguous()
            k2 = cuda_fq.fq2_mul(a2, b2)
            p2 = cuda_fq.fq2_mul_plain(a2, b2)
            torch.cuda.synchronize()
            for name, kk, pp in (("fq_mul", k, p), ("fq2_mul", k2, p2)):
                err = int((kk.long() - pp.long()).abs().max())
                max_err[name] = max(max_err[name], err)
                if not torch.equal(kk, pp):
                    raise AssertionError(f"{name} n={n} {kind}: kernel != plain (max err {err})")
                if int(kk.abs().max()) >= bound[name]:
                    raise AssertionError(f"{name} n={n} {kind}: output limb above its bound")
            kc, k2c = k.cpu(), k2.cpu()
            for i in sample_rows(n):
                if from_limbs16(kc[i]) != va[i] * vb[i] % P:
                    raise AssertionError(f"fq_mul n={n} {kind} row {i}: wrong value")
                x0, x1 = va[i], vb[(i - 1) % n]
                y0, y1 = vb[i], va[(i - 2) % n]
                c0 = (x0 * y0 - x1 * y1) % P
                c1 = (x0 * y1 + x1 * y0) % P
                if (from_limbs16(k2c[i, 0]), from_limbs16(k2c[i, 1])) != (c0, c1):
                    raise AssertionError(f"fq2_mul n={n} {kind} row {i}: wrong value")
        log(f"[kernels] n={n}: fq_mul and fq2_mul equal their plain versions "
            f"(canonical, redundant, negative, edge); sampled values match")
    return max_err


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def runtime_mark() -> dict:
    """Where the flight recorder and the fallback counter stand, for
    :func:`assert_on_device`."""
    from lighthouse_tpu_torch import device_telemetry, metrics

    return {"seq": device_telemetry.FLIGHT_RECORDER.recorded_total,
            "fallback": metrics.DEVICE_HOST_FALLBACK.snapshot()}


def assert_on_device(label: str, mark: dict) -> list:
    """Fail unless every batch recorded since ``mark`` ran on the card: no
    flight record with a host fallback, no rise of any fallback counter,
    both breakers closed.  Returns the records, oldest first."""
    from lighthouse_tpu_torch import device_supervisor, device_telemetry, metrics

    rec = device_telemetry.FLIGHT_RECORDER
    records = [r for r in reversed(rec.recent(limit=rec.capacity)) if r["seq"] > mark["seq"]]
    if not records:
        raise AssertionError(f"{label}: no batch reached the flight recorder")
    fallen = [r for r in records if r["host_fallback"]]
    if fallen:
        raise AssertionError(f"{label}: batches took the host route: {fallen}")
    if metrics.DEVICE_HOST_FALLBACK.snapshot() != mark["fallback"]:
        raise AssertionError(f"{label}: host-fallback counter rose: "
                             f"{metrics.DEVICE_HOST_FALLBACK.snapshot()}")
    for op in ("bls_verify", "kzg_batch", "sha256_pairs", "tree_hash", "epoch_deltas",
               "epoch_boundary", "epoch_boundary_leak"):
        if device_supervisor.breaker_state(op) != "closed":
            raise AssertionError(f"{label}: {op} breaker is {device_supervisor.breaker_state(op)}")
    return records


def last_stages(op: str) -> dict:
    """The newest ``op`` batch's stages from the flight recorder, as
    ``build`` (setup: weights, hashing, packing, upload), ``device``
    (dispatch + wait: the program to the end of its work on the card) and
    ``verdict``."""
    from lighthouse_tpu_torch import device_telemetry

    st = device_telemetry.FLIGHT_RECORDER.recent(limit=1, op=op)[0]["stages_s"]
    return {"build": st["setup"], "device": st["dispatch"] + st["wait"],
            "verdict": st["verdict"]}


def timed_verify(label: str, sets, expect: bool) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api

    mark = runtime_mark()
    t0 = time.perf_counter()
    ok = api.verify_signature_sets(sets)
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    assert_on_device(label, mark)
    stages = last_stages("bls_verify")
    log(f"[verify] {label}: verdict {ok} in {seconds:.3f} s "
        f"(build {stages['build']:.3f} s, device {stages['device']:.3f} s, "
        f"verdict {stages['verdict']:.3f} s); "
        f"{len(sets) / seconds:.1f} sets/s end to end, "
        f"{len(sets) / stages['device']:.1f} sets/s on the device program")
    return {"seconds": seconds, "stages": stages, "sets": len(sets)}


def phase_verify(cuda_fq) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api, set_backend
    from lighthouse_tpu_torch.workload import committee_sets

    t0 = time.perf_counter()
    main_sets = committee_sets(*MAIN, seed=3)
    gossip_sets = committee_sets(*GOSSIP, seed=4)
    log(f"[verify] host prep (keys, hash-to-G2, signing) for {tag(MAIN)} + {tag(GOSSIP)}: "
        f"{time.perf_counter() - t0:.1f} s")
    set_backend("torch")
    timed_verify("warm-up 2x2", committee_sets(2, 2, seed=5), True)

    # The main path: counts set to 0 just before, read just after.
    cuda_fq.reset_launch_counts()
    main = timed_verify(f"{tag(MAIN)} valid", main_sets, True)
    launches = dict(cuda_fq.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
    rows = {name: sum(n * c for n, c in s.items()) for name, s in sizes.items()}
    max_rows = {name: max(s, default=0) for name, s in sizes.items()}
    log(f"[verify] {tag(MAIN)} kernel launches {launches}, rows {rows}, largest launch {max_rows}, "
        f"distinct launch sizes { {name: len(s) for name, s in sizes.items()} }")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    again = timed_verify(f"{tag(MAIN)} valid (second run)", main_sets, True)
    tampered = list(main_sets)
    forged = committee_sets(1, MAIN[1], seed=9)[0]
    victim = len(tampered) // 2
    tampered[victim] = api.SignatureSet.multiple_pubkeys(
        forged.signature, main_sets[victim].signing_keys, main_sets[victim].message)
    timed_verify(f"{tag(MAIN)} one tampered set", tampered, False)
    cuda_fq.reset_launch_counts()
    gossip = timed_verify(f"{tag(GOSSIP)} gossip batch", gossip_sets, True)
    log(f"[verify] {tag(GOSSIP)} kernel launches {dict(cuda_fq.LAUNCHES)}")
    return {"launches": launches, "sizes": sizes,
            "main": main, "again": again, "gossip": gossip,
            "sets": {"main": main_sets, "gossip": gossip_sets}}


def phase_parity() -> None:
    import torch

    from lighthouse_tpu_torch.crypto.bls.backends.host import _rand_scalars
    from lighthouse_tpu_torch.ops import pairing, verify
    from lighthouse_tpu_torch.workload import committee_sets

    sets = committee_sets(4, 4, seed=11)
    host_batch = verify.build_batch(sets, _rand_scalars(4, b"chip-smoke-parity"))
    t0 = time.perf_counter()
    fe_gpu, _ = verify._device_verify(*verify.batch_from_numpy(host_batch, "cuda"))
    fe_gpu = fe_gpu.cpu()
    t1 = time.perf_counter()
    fe_cpu, _ = verify._device_verify(*verify.batch_from_numpy(host_batch, "cpu"))
    t2 = time.perf_counter()
    if not torch.equal(fe_gpu, fe_cpu):
        raise AssertionError("4x4 parity: card fe != CPU fe")
    if not pairing.fe_is_one(fe_gpu):
        raise AssertionError("4x4 parity: valid batch did not verify")
    log(f"[parity] 4x4 fe equal limb for limb on cuda ({t1 - t0:.3f} s) and cpu "
        f"({t2 - t1:.3f} s); verdict True")


def kzg_inputs(child: "CpuChild" = None) -> tuple:
    """The mainnet setup, a ``Kzg`` at the default device, and KZG_BLOBS
    distinct blobs from a seed with their commitments and proofs (from
    ``child``'s host run where given, else computed here on the host)."""
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup

    t0 = time.perf_counter()
    setup = TrustedSetup.from_json(KZG_SETUP.read_text(), validate=False)
    t1 = time.perf_counter()
    kzg = Kzg(setup)
    blobs = kzg_blobs()
    if child is None:
        commitments, proofs = host_commitments(kzg, blobs)
        where = f"on the host in {time.perf_counter() - t1:.1f} s"
    else:
        out = child.result("kzg.json", CHILD_WAIT_S)
        commitments = [bytes.fromhex(c) for c in out["commitments"]]
        proofs = [bytes.fromhex(p) for p in out["proofs"]]
        where = (f"on the host in a child process in {out['seconds']:.1f} s (waited "
                 f"{time.perf_counter() - t1:.1f} s here)")
    log(f"[kzg] mainnet setup ({setup.width} G1 points) loaded in {t1 - t0:.1f} s; "
        f"{KZG_BLOBS} blobs committed and proved {where}")
    return kzg, blobs, commitments, proofs


def timed_kzg(label: str, fn, expect: bool, lanes: int) -> dict:
    """Run one KZG batch; the host stage is the time outside the device
    entry point's own stages (parsing, challenges, evaluations)."""
    mark = runtime_mark()
    t0 = time.perf_counter()
    ok = fn()
    seconds = time.perf_counter() - t0
    if ok is not expect:
        raise AssertionError(f"{label}: verdict {ok}, expected {expect}")
    assert_on_device(label, mark)
    stages = last_stages("kzg_batch")
    stages["host"] = seconds - sum(stages.values())
    log(f"[kzg] {label}: verdict {ok} in {seconds:.3f} s (host {stages['host']:.3f} s, "
        f"build {stages['build']:.3f} s, device {stages['device']:.3f} s, "
        f"verdict {stages['verdict']:.3f} s); {lanes / seconds:.1f} blobs/s end to end, "
        f"{lanes / stages['device']:.1f} blobs/s on the device program")
    return {"seconds": seconds, "stages": stages, "lanes": lanes}


def counted(cuda_fq, label: str, run) -> tuple:
    """``run()`` with the launch counts set to 0 just before and read just
    after; fails unless both kernels were launched."""
    cuda_fq.reset_launch_counts()
    out = run()
    launches = dict(cuda_fq.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
    log(f"[kzg] {label} kernel launches {launches}, "
        f"distinct launch sizes { {name: len(s) for name, s in sizes.items()} }")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched in {label}")
    return out, {"launches": launches, "sizes": sizes}


def blob_lanes(kzg, blobs, commitments, proofs):
    """The blobs' challenges z, evaluations y and parsed points, computed
    once per blob, and a function that gives the device entry point's
    arguments for the first ``n`` blobs tiled ``reps`` times (with lane
    ``bad``'s y changed to y + 1 mod R if given), the r powers hashed from
    those lanes as ``Kzg`` hashes them."""
    from lighthouse_tpu_torch.crypto.bls.params import R
    from lighthouse_tpu_torch.crypto.kzg import blob_to_polynomial
    from lighthouse_tpu_torch.crypto.kzg.kzg import _bytes_to_g1, _g1_to_curve_point

    t0 = time.perf_counter()
    zs = [kzg.compute_challenge(b, c) for b, c in zip(blobs, commitments)]
    ys = [kzg.evaluate_polynomial_in_evaluation_form(blob_to_polynomial(b), z)
          for b, z in zip(blobs, zs)]
    c_pts = [_g1_to_curve_point(_bytes_to_g1(c)) for c in commitments]
    p_pts = [_g1_to_curve_point(_bytes_to_g1(p)) for p in proofs]
    log(f"[kzg] host prep of {len(blobs)} distinct blobs (challenges, evaluations, "
        f"parsing): {time.perf_counter() - t0:.3f} s")

    def lanes(reps: int, n: int = len(blobs), bad=None) -> tuple:
        lane_ys = ys[:n] * reps
        if bad is not None:
            lane_ys[bad] = (lane_ys[bad] + 1) % R
        lane_zs = zs[:n] * reps
        r_powers = kzg._compute_r_powers(commitments[:n] * reps, lane_zs, lane_ys,
                                         proofs[:n] * reps)
        return (c_pts[:n] * reps, p_pts[:n] * reps, r_powers, lane_zs, lane_ys,
                kzg.setup.g2_monomial[1])

    return lanes


def phase_kzg(cuda_fq, kzg, blobs, commitments, proofs, lanes) -> dict:
    """The six blobs through ``Kzg`` and the 192 lanes through
    ``ops.kzg_device`` (see the module docstring).  Where the program's
    device time goes is not traced here: ``profile_verify.trace`` of one
    192-lane run gave 45,127–45,292 launches and a device busy share of
    5.8–7.0 % in every run that took it (PERF.md)."""
    from lighthouse_tpu_torch.ops import kzg_device

    # One block's blobs through the user's entry point, at the default device.
    block, block_counts = counted(cuda_fq, f"{KZG_BLOBS} blobs", lambda: timed_kzg(
        f"{KZG_BLOBS} blobs valid",
        lambda: kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs), True, KZG_BLOBS))
    swapped = [proofs[1], proofs[0], *proofs[2:]]
    timed_kzg(f"{KZG_BLOBS} blobs, two proofs swapped",
              lambda: kzg.verify_blob_kzg_proof_batch(blobs, commitments, swapped), False, KZG_BLOBS)

    # The Deneb target: the six tiled over 32 blocks.
    reps = KZG_LANES // KZG_BLOBS
    wide, wide_counts = counted(cuda_fq, f"{KZG_LANES} lanes", lambda: timed_kzg(
        f"{KZG_LANES} lanes valid",
        lambda: kzg_device.verify_kzg_proof_batch_device(*lanes(reps)), True, KZG_LANES))
    timed_kzg(f"{KZG_LANES} lanes, one y + 1",
              lambda: kzg_device.verify_kzg_proof_batch_device(*lanes(reps, bad=KZG_LANES // 2)),
              False, KZG_LANES)

    return {"block": block, "wide": wide, "kzg6": block_counts, "kzg192": wide_counts}


def phase_kzg_parity(lanes) -> None:
    import torch

    from lighthouse_tpu_torch.ops import kzg_device, pairing

    host_batch = kzg_device._build_kzg_batch(*lanes(1, n=2), 2)
    t0 = time.perf_counter()
    fe_gpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cuda")).cpu()
    t1 = time.perf_counter()
    fe_cpu = kzg_device._device_kzg_batch(*kzg_device.batch_from_numpy(host_batch, "cpu"))
    t2 = time.perf_counter()
    if not torch.equal(fe_gpu, fe_cpu):
        raise AssertionError("2-blob KZG parity: card fe != CPU fe")
    if not pairing.fe_is_one(fe_gpu):
        raise AssertionError("2-blob KZG parity: valid batch did not verify")
    log(f"[kzg parity] 2-blob fe equal limb for limb on cuda ({t1 - t0:.3f} s) and cpu "
        f"({t2 - t1:.3f} s); verdict True")


def forge(sets: list, victim: int, seed: int) -> list:
    """``sets`` with set ``victim``'s signature replaced by another
    committee's signature over the same message."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.workload import committee_sets

    out = list(sets)
    forged = committee_sets(1, len(sets[victim].signing_keys), seed=seed)[0]
    out[victim] = api.SignatureSet.multiple_pubkeys(
        forged.signature, sets[victim].signing_keys, sets[victim].message)
    return out


def phase_runtime(cuda_fq, card: str, kzg, blobs, commitments, proofs,
                  device: str = "cuda") -> dict:
    """The device runtime at full width (see the module docstring)."""
    import threading

    from lighthouse_tpu_torch import device_pipeline, device_telemetry, metrics
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import verify
    from lighthouse_tpu_torch.workload import committee_sets

    t0 = time.perf_counter()
    groups = [("block_import", committee_sets(*MAIN, seed=31), True)]
    groups += [("gossip_attestation", committee_sets(8, 1, seed=40 + i), True) for i in range(8)]
    groups += [("gossip_attestation", forge(committee_sets(8, 1, seed=50), 3, seed=51), False)]
    log(f"[runtime] host prep of 1 x {tag(MAIN)} + 9 x 8x1 groups: {time.perf_counter() - t0:.1f} s")

    want = [expect for _, _, expect in groups]

    def drive(label: str) -> tuple:
        """The ten groups from ten threads at once, the hash-to-G2 cache
        cold; fails unless every verdict is as expected and every batch
        ran on the card.  Returns the wall seconds and the records."""
        verify._hash_cache.clear()
        verdicts: list = [None] * len(groups)
        start = threading.Barrier(len(groups))

        def call(i: int, kind: str, sets: list) -> None:
            with device_pipeline.work_context(kind):
                start.wait()
                verdicts[i] = api.verify_signature_sets(sets, device=device)

        threads = [threading.Thread(target=call, args=(i, kind, sets), name=f"runtime-{i}")
                   for i, (kind, sets, _) in enumerate(groups)]
        mark = runtime_mark()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if verdicts != want:
            raise AssertionError(f"[runtime] {label}: verdicts {verdicts}, expected {want}")
        records = assert_on_device(f"[runtime] {label}", mark)
        if any(metrics.DEVICE_HOST_FALLBACK.snapshot().values()):
            raise AssertionError(f"[runtime] {label}: host fallbacks "
                                 f"{metrics.DEVICE_HOST_FALLBACK.snapshot()}")
        for r in records:
            log(f"[runtime]   {label}: batch seq {r['seq']} shape {r['shape']} n_groups "
                f"{r.get('n_groups')} verdict {r['verdict']} stages {r['stages_s']} "
                f"work_mix {r.get('work_mix')}")
        return wall, records

    device_pipeline.enable(device=device)
    pipe = device_pipeline.get_pipeline()
    # A block's 128 sets fill a batch alone, so a failing gossip batch never
    # re-checks the block on the host; gossip groups coalesce among
    # themselves.  The linger is pinned so that groups arriving together
    # are taken together.
    pipe.target_sets = MAIN[0]
    pipe.linger_s = RUNTIME_LINGER_S
    cuda_fq.reset_launch_counts()
    wall, records = drive("pipeline on")
    launches = dict(cuda_fq.LAUNCHES)
    snap = device_pipeline.summary()
    device_pipeline.shutdown()
    if not any(r.get("n_groups", 1) >= 2 for r in records):
        raise AssertionError(f"[runtime] no coalesced batch: {records}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched in the runtime phase")
    batches = snap["recent_batches"]
    busy = snap["builder_busy_s"] + snap["executor_busy_s"]
    log(f"[runtime] {card}: {len(groups)} groups ({sum(len(g[1]) for g in groups)} sets) "
        f"from {len(groups)} threads in {wall:.3f} s: {snap['batches_total']} batches, "
        f"n_groups {[b['n_groups'] for b in batches]}, sets {[b['n_sets'] for b in batches]}, "
        f"fill ratio {[b['fill_ratio'] for b in batches]} of target {snap['target_sets']}, "
        f"effective linger {snap['effective_linger_s']} s, linger waited "
        f"{[b['linger_s'] for b in batches]} s, group re-checks "
        f"{[b['group_rechecks'] for b in batches]}; builder busy {snap['builder_busy_s']:.3f} s, "
        f"executor busy {snap['executor_busy_s']:.3f} s, sum {busy:.3f} s = "
        f"{busy / wall:.1%} of the wall; kernel launches {launches}")
    # The same traffic with the pipeline off: each caller's own batch on
    # the direct supervised path (the supervisor's one worker per op
    # serializes the device stages; the builds run in the callers).
    wall_off, records_off = drive("pipeline off")
    log(f"[runtime] {card}: the same {len(groups)} groups with the pipeline off: "
        f"{len(records_off)} batches in {wall_off:.3f} s (pipeline on: {len(records)} "
        f"batches in {wall:.3f} s)")

    mark = runtime_mark()
    t0 = time.perf_counter()
    if kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs) is not True:
        raise AssertionError("[runtime] 6-blob KZG batch did not verify")
    kzg_s = time.perf_counter() - t0
    rec = assert_on_device("[runtime] kzg", mark)[-1]
    log(f"[runtime] {card}: {KZG_BLOBS}-blob KZG batch under the supervisor: verdict True in "
        f"{kzg_s:.3f} s, breaker {rec['breaker_state']}, stages {rec['stages_s']}")
    summary = device_telemetry.summary()
    log(f"[runtime] host fallbacks {summary['host_fallbacks']}, breakers "
        f"{[(b['op'], b['state']) for b in summary['supervisor']['breakers']]}")
    return {"wall_s": wall, "wall_off_s": wall_off, "pipeline": snap, "launches": launches,
            "kzg_s": kzg_s}


def sha_words(rng, shape) -> "np.ndarray":
    import numpy as np

    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def phase_hash_kernels() -> dict:
    """Both SHA-256 kernels against their plain versions on the card, word
    for word, and against hashlib (see the module docstring)."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops import cuda_sha, tree_hash

    rng = np.random.default_rng(0x5A256)
    max_err = {"sha256_pairs": 0, "tree_hash_subtrees": 0}

    def checked_rows(n: int) -> list:
        return (list(range(n)) if n <= HASHLIB_ALL
                else sorted(rng.choice(n, HASHLIB_ALL, replace=False).tolist()))

    for n in PAIR_NS:
        words = sha_words(rng, (n, 16))
        x = torch.from_numpy(words.view(np.int32)).cuda()
        k, p = cuda_sha.sha256_pairs(x), cuda_sha.sha256_pairs_plain(x)
        torch.cuda.synchronize()
        err = int((k.long() - p.long()).abs().max())
        max_err["sha256_pairs"] = max(max_err["sha256_pairs"], err)
        if not torch.equal(k, p):
            raise AssertionError(f"sha256_pairs n={n}: kernel != plain (max err {err})")
        digests = k.cpu().numpy().view(np.uint32).astype(">u4")
        blocks = words.astype(">u4")
        rows = checked_rows(n)
        for i in rows:
            if hashlib.sha256(blocks[i].tobytes()).digest() != digests[i].tobytes():
                raise AssertionError(f"sha256_pairs n={n} row {i}: digest != hashlib")
        log(f"[hash-kernels] sha256_pairs n={n}: kernel equals its plain version; "
            f"{len(rows)} rows equal hashlib")
    for m in SUBTREE_MS:
        leaves = sha_words(rng, (m, 32, 8))
        x = torch.from_numpy(leaves.view(np.int32)).cuda()
        p = cuda_sha.tree_hash_subtrees_plain(x)
        for threads in (None,) + cuda_sha.SUBTREE_THREADS:
            k = cuda_sha._tree_hash_subtrees_t(x, threads)
            torch.cuda.synchronize()
            for d, (kk, pp) in enumerate(zip(k, p)):
                err = int((kk.long() - pp.long()).abs().max())
                max_err["tree_hash_subtrees"] = max(max_err["tree_hash_subtrees"], err)
                if not torch.equal(kk, pp):
                    raise AssertionError(f"tree_hash_subtrees m={m} T={threads} level {d}: "
                                         f"kernel != plain")
            if threads is None:
                rows = checked_rows(m)
                golden = tree_hash._host_subtree_levels(leaves[rows])
                for d, (kk, g) in enumerate(zip(k, golden)):
                    if not np.array_equal(kk.cpu().numpy().view(np.uint32)[rows], g):
                        raise AssertionError(f"tree_hash_subtrees m={m} level {d}: != hashlib")
        log(f"[hash-kernels] tree_hash_subtrees m={m}: all five levels equal the plain "
            f"version at T = {cuda_sha.subtree_threads(m)} (the table's) and at every T of "
            f"{cuda_sha.SUBTREE_THREADS}; {len(rows)} subtrees equal hashlib")
    return max_err


def hash_records_since(mark: dict) -> list:
    """The flight records of the two hashing ops since ``mark``."""
    from lighthouse_tpu_torch import device_telemetry

    rec = device_telemetry.FLIGHT_RECORDER
    return [r for r in rec.recent(limit=rec.capacity)
            if r["seq"] > mark["seq"] and r["op"] in ("sha256_pairs", "tree_hash")]


def device_seconds(records: list) -> float:
    return sum(r.get("stages_s", {}).get("dispatch", 0.0) + r.get("stages_s", {}).get("wait", 0.0)
               for r in records)


def phase_state(card: str, device: str = "cuda") -> dict:
    """BeaconState tree hashing at mainnet width on the default device (see
    the module docstring).  The launch counts are set to 0 just before the
    device engines' first root and read just after their last."""
    from lighthouse_tpu_torch.ops import cuda_sha
    from lighthouse_tpu_torch.ops import sha256_device as sd
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import append_validators, mutate_balances, random_state

    t0 = time.perf_counter()
    state, types = random_state(STATE_VALIDATORS, seed=0x57A7E)
    build_s = time.perf_counter() - t0
    log(f"[state] Deneb mainnet-preset state with {len(state.validators)} validators built "
        f"from a seed in {build_s:.2f} s")

    host_cache = dev_cache = None

    def golden(label: str) -> tuple:
        """The root with the device engines off, on the native host kernel
        (the state's host-engine cache, kept incremental across steps)."""
        nonlocal host_cache, dev_cache
        dev_cache = getattr(state, "_thc", None)
        sd.uninstall_device_hash()
        th.configure(enabled=False)
        state._thc = host_cache
        t = time.perf_counter()
        root = state.hash_tree_root()
        seconds = time.perf_counter() - t
        host_cache = state._thc
        log(f"[state] {label} golden root (host engines, native SHA) in {seconds:.2f} s")
        return root, seconds

    def device_root(label: str, mark: dict) -> dict:
        nonlocal dev_cache
        th.configure(enabled=True, device=device)
        sd.install_device_hash(device=device)
        state._thc = dev_cache
        sd.reset_routes()
        before = dict(cuda_sha.LAUNCHES)
        t = time.perf_counter()
        root = state.hash_tree_root()
        wall = time.perf_counter() - t
        dev_cache = state._thc
        records = hash_records_since(mark)
        mark["seq"] = max([mark["seq"]] + [r["seq"] for r in records])
        dev_s = device_seconds(records)
        launches = {k: v - before[k] for k, v in cuda_sha.LAUNCHES.items()}
        out = {"root": root, "wall_s": wall, "device_s": dev_s, "host_s": wall - dev_s,
               "launches": launches, "blocks": dict(sd.ROUTE_BLOCKS),
               "route_s": {k: round(v, 4) for k, v in sd.ROUTE_SECONDS.items()},
               "batches": len(records)}
        log(f"[state] {label} root on {card}: {wall:.2f} s (host {wall - dev_s:.2f} s, device "
            f"stages {dev_s:.3f} s over {len(records)} supervised batches); kernel launches "
            f"{launches}")
        log(f"[state] {label} blocks by route: card via the subtree kernel "
            f"{out['blocks'].get('device_subtree', 0)}, card via the pair kernel "
            f"{out['blocks'].get('device_pairs', 0)}, host below a threshold "
            f"{out['blocks'].get('host_below', 0)}, host above the top bucket "
            f"{out['blocks'].get('host_above', 0)}; seconds by route {out['route_s']}")
        return out

    golden_full, golden_full_s = golden("full")
    start = runtime_mark()
    mark = dict(start)
    cuda_sha.reset_launch_counts()
    full = device_root("full", mark)
    if full["root"] != golden_full:
        raise AssertionError("[state] full root on the card != host golden")
    # One slot's changes in two steps: the balance side, then the deposits.
    # Appended validators change the length of every registry-sized list,
    # so each of their trees rebuilds through the subtree kernel (as in the
    # JAX package); the dirty-path pair batches show in the balance step.
    counts = mutate_balances(state, seed=0x5107, dirty_fraction=STATE_DIRTY_FRACTION,
                             effective=STATE_EFFECTIVE)
    golden_bal, golden_bal_s = golden("after the balance changes")
    balances = device_root(f"incremental ({counts})", mark)
    if balances["root"] != golden_bal:
        raise AssertionError("[state] root after the balance changes != host golden")
    # The deposits on a state of their own: appending resets the registry
    # cache (as in the JAX package), so at 2^20 the step repeats the full
    # root.
    t0 = time.perf_counter()
    state, types = random_state(STATE_DEPOSIT_VALIDATORS, seed=0x57A7E)
    host_cache = dev_cache = None
    deposit_build_s = time.perf_counter() - t0
    golden_base, _ = golden(f"deposit state ({STATE_DEPOSIT_VALIDATORS} validators, built in "
                            f"{deposit_build_s:.2f} s) full")
    base = device_root(f"deposit state ({STATE_DEPOSIT_VALIDATORS} validators) full", mark)
    if base["root"] != golden_base:
        raise AssertionError("[state] the deposit state's full root on the card != host golden")
    counts = append_validators(state, types, seed=0xDE90, count=STATE_APPENDED)
    golden_dep, golden_dep_s = golden("after the deposits")
    deposits = device_root(f"incremental ({counts})", mark)
    if deposits["root"] != golden_dep:
        raise AssertionError("[state] root after the deposits != host golden")
    launches = dict(cuda_sha.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_sha.SIZES.items()}
    sd.uninstall_device_hash()
    th.configure(enabled=False)
    assert_on_device("[state]", start)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the [state] path")
    log(f"[state] {card}: full and balance-step roots at {STATE_VALIDATORS} validators, full "
        f"and deposit-step roots at {STATE_DEPOSIT_VALIDATORS}, each equal to the host golden; "
        f"kernel launches {launches}, launch sizes {sizes}; no host fallback, breakers closed")
    return {"launches": launches, "sizes": sizes, "build_s": build_s,
            "roots": {"full": full, "balances": balances, "deposit_base": base,
                      "deposits": deposits},
            "golden_s": {"full": golden_full_s, "balances": golden_bal_s,
                         "deposits": golden_dep_s},
            "validators": STATE_VALIDATORS}


def phase_hash_runtime(card: str, device: str = "cuda") -> dict:
    """Both pipelines on the card at once (see the module docstring)."""
    import threading

    import numpy as np

    from lighthouse_tpu_torch import device_pipeline, device_telemetry
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import committee_sets

    rng = np.random.default_rng(0x4A54)
    t0 = time.perf_counter()
    th.configure(enabled=True, device=device)
    trees, targets, goldens = [], [], []
    for _ in range(HASH_THREADS):
        leaves = rng.integers(0, 256, (HASH_TREE_LEAVES, 32), dtype=np.uint8)
        tree = th.DeviceLeafTree(HASH_TREE_LEAVES)
        tree.update(leaves)
        dirty = rng.choice(HASH_TREE_LEAVES, int(HASH_TREE_LEAVES * HASH_DIRTY_FRACTION),
                           replace=False)
        mutated = leaves.copy()
        mutated[dirty] ^= 0xA5
        trees.append(tree)
        targets.append(mutated)
        goldens.append(th.golden_root(mutated, HASH_TREE_LEAVES))
    block = committee_sets(*MAIN, seed=61)
    log(f"[hash-runtime] {HASH_THREADS} trees of {HASH_TREE_LEAVES} leaves built through the "
        f"subtree kernel, their hashlib golden roots and one {tag(MAIN)} group prepared in "
        f"{time.perf_counter() - t0:.1f} s")

    device_pipeline.enable(device=device)
    hash_pipe = device_pipeline.get_hash_pipeline()
    hash_pipe.linger_s = RUNTIME_LINGER_S
    bls_pipe = device_pipeline.get_pipeline()
    bls_pipe.target_sets = MAIN[0]
    bls_pipe.linger_s = RUNTIME_LINGER_S
    roots: list = [None] * HASH_THREADS
    verdict: list = [None]
    start = threading.Barrier(HASH_THREADS + 1)

    def update(i: int) -> None:
        with device_pipeline.work_context("tree_hash"):
            start.wait()
            roots[i] = trees[i].update(targets[i])

    def verify() -> None:
        with device_pipeline.work_context("block_import"):
            start.wait()
            verdict[0] = api.verify_signature_sets(block, device=device)

    threads = [threading.Thread(target=update, args=(i,), name=f"hash-runtime-{i}")
               for i in range(HASH_THREADS)]
    threads.append(threading.Thread(target=verify, name="hash-runtime-bls"))
    mark = runtime_mark()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    snap = device_pipeline.summary()
    device_pipeline.shutdown()
    th.configure(enabled=False)
    if roots != goldens:
        raise AssertionError("[hash-runtime] a tree's root != golden_root")
    if verdict[0] is not True:
        raise AssertionError(f"[hash-runtime] {tag(MAIN)} verdict {verdict[0]}")
    assert_on_device("[hash-runtime]", mark)
    batches = snap["hash"]["recent_batches"]
    if not any(b["n_groups"] >= 2 for b in batches):
        raise AssertionError(f"[hash-runtime] no coalesced hash batch: {batches}")
    grants = snap["arbiter"]["grants"]
    if not (grants.get("sha256_pairs", 0) >= 1 and grants.get("bls_verify", 0) >= 1):
        raise AssertionError(f"[hash-runtime] arbiter grants {grants}")
    if any(b["group_rehashes"] or b["group_errors"] for b in batches):
        raise AssertionError(f"[hash-runtime] groups re-hashed or failed: {batches}")
    log(f"[hash-runtime] {card}: {HASH_THREADS} tree updates ({HASH_DIRTY_FRACTION:.0%} dirty) "
        f"and one {tag(MAIN)} verify from {len(threads)} threads in {wall:.3f} s; every root "
        f"equals golden_root, verdict True; hash batches {snap['hash']['batches_total']} "
        f"(groups {[b['n_groups'] for b in batches]}, blocks {[b['n_blocks'] for b in batches]}), "
        f"arbiter grants {grants}, waits {snap['arbiter']['wait_s']} s; host fallbacks "
        f"{device_telemetry.host_fallback_counts()}")
    return {"wall_s": wall, "hash": snap["hash"], "arbiter": snap["arbiter"]}


# ------------------------------------------------------------ mesh, autotune


#: [mesh]: the two members of the mesh on the one card, the live rows of
#: its two verifies (buckets 128 x 32 and 64 x 1, padded), the tampered
#: set's row (in the second shard), the reshard batch, the 2^16-validator
#: balance list and the pair batch.
MESH_DEVICES = ("cuda:0", "cuda:0")
MESH_VERIFIES = ((MAIN[0] - 1, MAIN[1]), (GOSSIP[0] - 1, GOSSIP[1]))
MESH_RESHARD_SETS = 15
MESH_BALANCES = 1 << 16
MESH_PAIRS = (1 << 16) + 1000


class ShardLaunches:
    """Kernel launches per mesh shard while in the block: each per-shard
    program (``owner.name``) wrapped to read ``counters`` before and after
    it, under ``device_mesh.current_shard()``."""

    def __init__(self, counters: dict, targets):
        self.counters, self.per_shard = counters, {}
        self.patch = Patched({}, [(o, n, n) for o, n in targets], wrap=self._wrap)

    def _wrap(self, spans, key, fn):
        import functools

        from lighthouse_tpu_torch import device_mesh

        @functools.wraps(fn)  # the mesh reads the program's parameters
        def run(*a, **kw):
            before = dict(self.counters)
            try:
                return fn(*a, **kw)
            finally:
                got = self.per_shard.setdefault(device_mesh.current_shard(),
                                                dict.fromkeys(self.counters, 0))
                for k in got:
                    got[k] += self.counters[k] - before[k]
        return run

    def __enter__(self):
        self.patch.__enter__()
        return self.per_shard

    def __exit__(self, *exc):
        return self.patch.__exit__(*exc)


def _fe_value(fe):
    from lighthouse_tpu_torch.ops import tower

    return tower.fq12_from_limbs(fe.cpu())


def mesh_verify(card: str, cuda_fq, sets: list, shape: tuple, device: str = "cuda") -> dict:
    """One verify shape on the two-shard mesh, with one tampered set in the
    second shard: through the supervised entry point on the shards
    (verdict False, each shard's Fq launches counted apart, the flight
    record's mesh fields, the combine's ``fe`` kept), and unsharded from
    the same host batch (the entry point's weights come from its seed):
    the two ``fe`` the same element of F_p^12."""
    from lighthouse_tpu_torch import device_mesh
    from lighthouse_tpu_torch.crypto.bls.backends.host import _rand_scalars
    from lighthouse_tpu_torch.ops import pairing, verify
    from lighthouse_tpu_torch.ops.devices import wait_for

    label = f"{shape[0]} x {shape[1]}"
    seed = b"chip-smoke-mesh"
    nb = verify._bucket(shape[0], verify.N_BUCKETS)
    victim = nb // 2 + (shape[0] - nb // 2) // 2  # a row of the second shard
    tampered = forge(sets, victim, seed=0x3E5)
    combined = []

    def keep(spans, key, fn):
        def run(*a, **kw):
            combined.append(fn(*a, **kw))
            return combined[-1]
        return run

    mark = runtime_mark()
    cuda_fq.reset_launch_counts()
    with Patched({}, [(verify, "_combine_shards", "combine")], wrap=keep), \
            ShardLaunches(cuda_fq.LAUNCHES, [(verify, "_device_verify_shard")]) as per_shard:
        t = time.perf_counter()
        ok = verify.verify_signature_sets_device(tampered, seed=seed, device=device)
        sharded_s = time.perf_counter() - t
    total = dict(cuda_fq.LAUNCHES)
    rec = assert_on_device(f"[mesh] {label}", mark)[-1]
    if ok is not False or rec["shape"] != f"{nb}x{shape[1]}@dp2" or \
            rec["shard_live"] != [nb // 2, shape[0] - nb // 2] or len(combined) != 1:
        raise AssertionError(f"[mesh] {label} tampered: verdict {ok}, record {rec}")
    if sorted(per_shard) != [0, 1] or any(n <= 0 for c in per_shard.values()
                                          for n in c.values()):
        raise AssertionError(f"[mesh] {label}: per-shard launches {per_shard}")
    combine = {k: total[k] - per_shard[0][k] - per_shard[1][k] for k in total}
    first = device_mesh.first_device()
    host = verify.build_batch(tampered, _rand_scalars(len(tampered), seed))
    t = time.perf_counter()
    fe_u, _ = verify._device_verify(*verify.batch_from_numpy(host, first))
    wait_for(first)
    unsharded_s = time.perf_counter() - t
    fe_s = combined[0][0]
    if _fe_value(fe_s) != _fe_value(fe_u) or pairing.fe_is_one(fe_u):
        raise AssertionError(f"[mesh] {label} tampered at row {victim}: sharded fe != "
                             "unsharded fe, or the unsharded verdict True")
    stages = rec["stages_s"]
    device_s = stages["dispatch"] + stages["wait"]
    log(f"[mesh] {card}: {label} (bucket {nb} x {shape[1]}) with one tampered set (row "
        f"{victim}, shard 1) on 2 shards of {first}: verdict False in {sharded_s:.3f} s "
        f"(device {device_s:.3f} s; record {rec['shape']}, rows per shard "
        f"{rec['shard_live']}); unsharded from the same host batch: device {unsharded_s:.3f} s, "
        f"fe the same element of F_p^12 (no scaling claimed: both shards share one card); "
        f"Fq launches shard 0 {per_shard[0]}, shard 1 {per_shard[1]}, combine {combine}")
    return {"sharded_s": sharded_s, "sharded_device_s": device_s,
            "unsharded_device_s": unsharded_s, "per_shard": per_shard, "combine": combine}


def phase_mesh(card: str, cuda_fq, verify_sets: dict, kzg, blobs, commitments,
               proofs, device: str = "cuda") -> dict:
    """[mesh]: the device mesh on the card (see the module docstring)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch import device_mesh, device_supervisor, device_telemetry
    from lighthouse_tpu_torch import fault_injection, metrics
    from lighthouse_tpu_torch.ops import cuda_sha, kzg_device, sha256_device, tree_hash

    out = {}
    size = device_mesh.configure("auto")
    if size != 0 or device_mesh.enabled():
        raise AssertionError(f"[mesh] configure('auto') over {torch.cuda.device_count()} "
                             f"card(s) gave size {size}")
    log(f"[mesh] {card}: configure('auto') over the {torch.cuda.device_count()} visible "
        f"card(s): size 0, the mesh disabled (single-device dispatch)")
    hashing_on = tree_hash.enabled()
    tree_hash.configure(enabled=True, device=device)
    try:
        if device_mesh.configure("auto", devices=MESH_DEVICES) != 2:
            raise AssertionError(f"[mesh] a mesh over {MESH_DEVICES} is not of size 2")
        main, gossip = verify_sets["main"], verify_sets["gossip"]
        out["verify"] = [mesh_verify(card, cuda_fq, main[:MESH_VERIFIES[0][0]],
                                     MESH_VERIFIES[0], device),
                         mesh_verify(card, cuda_fq, gossip[:MESH_VERIFIES[1][0]],
                                     MESH_VERIFIES[1], device)]

        # KZG: the six blobs, unsharded, then on the two shards (valid, and
        # two proofs swapped).
        mark = runtime_mark()
        device_mesh.configure("0")
        t = time.perf_counter()
        ok_u = kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs)
        kzg_u = time.perf_counter() - t
        device_mesh.configure("auto", devices=MESH_DEVICES)
        cuda_fq.reset_launch_counts()
        with ShardLaunches(cuda_fq.LAUNCHES, [(kzg_device, "_kzg_shard")]) as per_shard:
            t = time.perf_counter()
            ok_s = kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs)
            kzg_s = time.perf_counter() - t
        rec = device_telemetry.FLIGHT_RECORDER.recent(1, op="kzg_batch")[0]
        swapped = [proofs[1], proofs[0], *proofs[2:]]
        bad = kzg.verify_blob_kzg_proof_batch(blobs, commitments, swapped)
        assert_on_device("[mesh] kzg", mark)
        if (ok_u, ok_s, bad) != (True, True, False) or rec["shape"] != "8@dp2" or \
                rec["shard_live"] != [4, 2] or sorted(per_shard) != [0, 1] or \
                not all(per_shard[s]["fq_mul"] > 0 for s in (0, 1)):
            raise AssertionError(f"[mesh] {KZG_BLOBS} blobs: verdicts {ok_u, ok_s, bad}, "
                                 f"record {rec}, per-shard launches {per_shard}")
        log(f"[mesh] {card}: {KZG_BLOBS} blobs: verdict True on 2 shards in {kzg_s:.3f} s, "
            f"unsharded {kzg_u:.3f} s; two proofs swapped False on 2 shards; record "
            f"{rec['shape']} rows per shard {rec['shard_live']}; Fq launches shard 0 "
            f"{per_shard[0]}, shard 1 {per_shard[1]}")
        out["kzg"] = {"sharded_s": kzg_s, "unsharded_s": kzg_u}

        # Hashing: a 2^16-validator balance list's root, a pair batch.
        rng = np.random.default_rng(0x3E5)
        balances = rng.integers(16 * 10**9, 33 * 10**9, MESH_BALANCES, dtype=np.uint64)
        leaves = np.frombuffer(balances.astype("<u8").tobytes(),
                               dtype=np.uint8).reshape(-1, 32)
        limit = (1 << 40) // 4
        data = rng.integers(0, 256, MESH_PAIRS * 64, dtype=np.uint8).tobytes()
        mark = runtime_mark()
        cuda_sha.reset_launch_counts()
        with ShardLaunches(cuda_sha.LAUNCHES, [(tree_hash, "_tree_hash_subtrees"),
                                               (sha256_device, "_sha256_64byte_batch")]
                           ) as per_shard:
            t = time.perf_counter()
            root_s = tree_hash.DeviceLeafTree(limit).update(leaves)
            tree_s = time.perf_counter() - t
            t = time.perf_counter()
            pairs_s = sha256_device.hash_pairs_device(data, device=device)
            pair_s = time.perf_counter() - t
        tree_rec = device_telemetry.FLIGHT_RECORDER.recent(1, op="tree_hash")[0]
        pair_rec = device_telemetry.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]
        device_mesh.configure("0")
        t = time.perf_counter()
        root_u = tree_hash.DeviceLeafTree(limit).update(leaves)
        tree_u = time.perf_counter() - t
        t = time.perf_counter()
        pairs_u = sha256_device.hash_pairs_device(data, device=device)
        pair_u = time.perf_counter() - t
        device_mesh.configure("auto", devices=MESH_DEVICES)
        assert_on_device("[mesh] hashing", mark)
        if root_s != root_u or root_u != tree_hash.golden_root(leaves, limit):
            raise AssertionError("[mesh] the balance list's root differs")
        if pairs_s != pairs_u or pairs_u != tree_hash.golden_hash_pairs(data):
            raise AssertionError("[mesh] the pair batch's digests differ")
        pair_nb = sha256_device._bucket(MESH_PAIRS)
        if not tree_rec["shape"].endswith("@dp2") or pair_rec["shape"] != f"{pair_nb}@dp2" or \
                sorted(per_shard) != [0, 1]:
            raise AssertionError(f"[mesh] hashing records {tree_rec['shape']}, "
                                 f"{pair_rec['shape']}, per-shard launches {per_shard}")
        log(f"[mesh] {card}: a {MESH_BALANCES}-validator balance list's root on 2 shards in "
            f"{tree_s:.3f} s (unsharded {tree_u:.3f} s), {MESH_PAIRS} pairs in {pair_s:.3f} s "
            f"(unsharded {pair_u:.3f} s): bytes equal to the unsharded ones and hashlib's; "
            f"records {tree_rec['shape']}, {pair_rec['shape']}; SHA launches shard 0 "
            f"{per_shard[0]}, shard 1 {per_shard[1]}")
        out["hash"] = {"tree_s": tree_s, "tree_u": tree_u, "pair_s": pair_s, "pair_u": pair_u}

        # The reshard: a fault charged to shard 1 (1 of its 2), split retry
        # on the card; a second one trips it, the mesh re-shards to one
        # member (off), and the batch retries single-device.
        sets = verify_sets["gossip"][:MESH_RESHARD_SETS]
        from lighthouse_tpu_torch.ops import verify

        reshards = sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values())
        splits = metrics.DEVICE_SPLIT_RETRIES.get(op="bls_verify", outcome="success")
        mark = runtime_mark()
        fault_injection.install("device.dispatch", "error", op="bls_verify", first_n=1)
        first = verify.verify_signature_sets_device(sets, seed=b"reshard", device=device)
        after_one = device_mesh.summary()
        # the split retry's halves (8 and 7 sets: bucket 8) ran on the shards
        half = verify._bucket(MESH_RESHARD_SETS - MESH_RESHARD_SETS // 2, verify.N_BUCKETS)
        halves_sharded = device_telemetry.COMPILE_CACHE.seen("bls_verify", (half, 1), mesh=2)
        fault_injection.install("device.dispatch", "error", op="bls_verify", first_n=1)
        t = time.perf_counter()
        second = verify.verify_signature_sets_device(sets, seed=b"reshard", device=device)
        retry_s = time.perf_counter() - t
        fault_injection.clear()
        rec = assert_on_device("[mesh] reshard", mark)[-1]
        snap = device_mesh.summary()
        moved = sum(metrics.DEVICE_MESH_RESHARDS.snapshot().values()) - reshards
        if (first, second) != (True, True) or after_one["size"] != 2 or not halves_sharded or \
                after_one["breakers"][1]["failures"] != 1 or \
                metrics.DEVICE_SPLIT_RETRIES.get(op="bls_verify", outcome="success") != \
                splits + 1 or (snap["size"], snap["enabled"], snap["reshards_total"]) != \
                (1, False, 1) or snap["breakers"][1]["state"] != "open" or moved != 1 or \
                rec["shape"] != f"{verify._bucket(MESH_RESHARD_SETS, verify.N_BUCKETS)}x1" or \
                device_supervisor.breaker_state("bls_verify") != "closed":
            raise AssertionError(f"[mesh] reshard: verdicts {first, second}, after one "
                                 f"fault {after_one}, after two {snap}, "
                                 f"device_mesh_reshards_total +{moved}, record {rec}")
        log(f"[mesh] {card}: {MESH_RESHARD_SETS} x 1 with a dispatch fault charged to shard 1 "
            f"(1 of {snap['device_failure_threshold']}): split retry on the card, its halves on "
            f"the 2 shards ({half} x 1@dp2), verdict True; a second fault trips shard 1: re-sharded to size {snap['size']} (mesh off), "
            f"the batch retried single-device in {retry_s:.3f} s, verdict True; "
            f"device_mesh_reshards_total +{moved}, breakers {snap['breakers']}")
    finally:
        fault_injection.clear()
        device_mesh.configure("0")
        tree_hash.configure(enabled=hashing_on)
    return out


def phase_autotune(card: str, device: str = "cuda") -> dict:
    """[autotune]: the measured walk lookahead and a live adoption on the
    card (see the module docstring)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch import autotune, device_telemetry
    from lighthouse_tpu_torch.ops import cuda_epoch, sha256_device, tree_hash

    dev = torch.device(device)
    out = {}
    # The measured choice: every lookahead on one small walk, supervised.
    decision = autotune.measure_walk_lookahead(force=True, device=dev)
    seed_words, pivots = autotune._probe_inputs(dev)
    plain = cuda_epoch.proposer_walk_plain(seed_words, pivots, autotune.PROBE_CANDIDATES,
                                           autotune.PROBE_ACTIVE)
    _, kernel = autotune._probe_walk(dev, decision["lookahead"], 1)
    if not torch.equal(kernel, plain.cpu()):
        raise AssertionError("[autotune] the probe walk != its plain version")
    if cuda_epoch.walk_lookahead(dev) != decision["lookahead"] or \
            autotune.cached_walk_lookahead(dev)["lookahead"] != decision["lookahead"]:
        raise AssertionError(f"[autotune] walk_lookahead() {cuda_epoch.walk_lookahead(dev)} "
                             f"after measuring {decision}")
    times = ", ".join(f"k={k} {float(s) * 1e3:.4f} ms"
                      for k, s in decision["measurements_s"].items())
    log(f"[autotune] {card}: proposer walk {decision['shape'][0]} x {decision['shape'][1]} x "
        f"{decision['shape'][2]} rounds, best of {decision['reps']}: {times}; every lookahead's "
        f"positions equal and equal the plain version's; k={decision['lookahead']} cached "
        f"under {decision['key']!r} ({autotune.walk_cache_path()}), walk_lookahead() now "
        f"{cuda_epoch.walk_lookahead(dev)}")
    out["walk"] = decision

    # Live adoption: sha256_pairs batches of 300 blocks (bucket 1024) on
    # top of the flight record the earlier phases filled, then one
    # evaluation starts the midpoint's warmup on the card, the next adopts.
    rng = np.random.default_rng(0xA7)
    before = autotune._bucket_live_stats(autotune._VOCABS["sha256_pairs"])
    for _ in range(autotune.MIN_SAMPLES):
        data = rng.integers(0, 256, 300 * 64, dtype=np.uint8).tobytes()
        if sha256_device.hash_pairs_device(data, device=dev) != \
                tree_hash.golden_hash_pairs(data):
            raise AssertionError("[autotune] a 300-block batch's digests differ")
    overlay_before = autotune.overlay().get("sha256_pairs", ())
    try:
        autotune.set_mode("live")
        started = autotune.CONTROLLER.evaluate()
        first = [d for d in started if (d.get("vocab"), d.get("bucket")) == ("sha256_pairs", 640)]
        deadline = time.time() + 120
        while any(autotune.CONTROLLER.warmup_state(d["vocab"], d["bucket"]) == "pending"
                  for d in started if d.get("outcome") == "warmup_started"):
            if time.time() > deadline:
                raise AssertionError("[autotune] the warmups did not finish in 120 s")
            time.sleep(0.01)
        warm = next(e for e in device_telemetry.COMPILE_CACHE.inventory()
                    if e["op"] == "sha256_pairs" and e["shape"] == "640")
        evaluated = autotune.CONTROLLER.evaluate()
        second = [d for d in evaluated
                  if (d.get("vocab"), d.get("bucket")) == ("sha256_pairs", 640)]
        # The earlier phases' traffic may give another sha256_pairs bucket
        # its own evidence: the overlay is then exactly what the two
        # evaluations adopted on top of what it held, 640 among them.
        adopted = {d["bucket"] for d in started + evaluated
                   if d.get("vocab") == "sha256_pairs" and d.get("outcome") == "adopted"}
        want_overlay = tuple(sorted(set(overlay_before) | adopted))
        others = [d for d in started + evaluated if d not in first + second]
        if [d["outcome"] for d in first] != ["warmup_started"] or \
                [d["outcome"] for d in second] != ["adopted"] or \
                warm.get("source") != "warmup" or 640 not in want_overlay or \
                autotune.overlay().get("sha256_pairs") != want_overlay:
            raise AssertionError(f"[autotune] decisions {first} then {second}, mirror {warm}, "
                                 f"overlay {autotune.overlay()} (want sha256_pairs "
                                 f"{want_overlay}), the evaluations' other decisions {others}")
        data = rng.integers(0, 256, 500 * 64, dtype=np.uint8).tobytes()
        if sha256_device.hash_pairs_device(data, device=dev) != \
                tree_hash.golden_hash_pairs(data):
            raise AssertionError("[autotune] a 500-block batch at 640 differs")
        rec = device_telemetry.FLIGHT_RECORDER.recent(1, op="sha256_pairs")[0]
        if rec["shape"] != "640" or rec["host_fallback"]:
            raise AssertionError(f"[autotune] the 500-block batch's record {rec}")
        log(f"[autotune] {card}: sha256_pairs evidence before this phase "
            f"{ {k: len(v) for k, v in sorted(before.items())} } batches a bucket, then "
            f"{autotune.MIN_SAMPLES} of 300 blocks at 1024; evaluation 1 "
            f"{first[0]['outcome']} (midpoint 640), the warmup's neutral dispatch on the card "
            f"{warm['compile_seconds']:.4f} s, evaluation 2 {second[0]['outcome']}; "
            f"sha256_pairs overlay {want_overlay} ({len(others)} other decisions); a 500-block "
            f"layer then dispatched at {rec['shape']}, digests equal to hashlib's")
        for d in autotune.CONTROLLER.decision_log():
            log(f"[autotune] decision {json.dumps(d, sort_keys=True)}")
        out["decisions"] = autotune.CONTROLLER.decision_log()
    finally:
        # back to the environment's mode, the static vocabularies
        autotune.reset_for_tests()
    return out


def counter_deltas(before: dict) -> dict:
    """Every supervisor counter series that moved since ``before``, as
    ``{"metric": {labels: delta}}``."""
    from lighthouse_tpu_torch import metrics

    out = {}
    for name, counter in SUPERVISOR_COUNTERS.items():
        moved = {",".join(f"{k}={v}" for k, v in key): value - before[name].get(key, 0.0)
                 for key, value in getattr(metrics, counter).snapshot().items()
                 if value != before[name].get(key, 0.0)}
        if moved:
            out[name] = moved
    return out


def counter_marks() -> dict:
    from lighthouse_tpu_torch import metrics

    return {name: getattr(metrics, c).snapshot() for name, c in SUPERVISOR_COUNTERS.items()}


def fault_case(label: str, run, expect, expect_deltas: dict) -> None:
    """Run one fault case; its outcome and every counter delta must be as
    expected, exactly.  ``expect`` is the verdict (or other value) the case
    returns, or the exception class it must raise.  The fault plans are
    cleared after it."""
    from lighthouse_tpu_torch import fault_injection

    before = counter_marks()
    t0 = time.perf_counter()
    try:
        out = run()
    except Exception as err:  # noqa: BLE001 — checked against ``expect`` below
        if not (isinstance(expect, type) and isinstance(err, expect)):
            raise
        out = err
    finally:
        fault_injection.clear()
    seconds = time.perf_counter() - t0
    got = counter_deltas(before)
    if isinstance(expect, type):
        if not isinstance(out, expect):
            raise AssertionError(f"[faults] {label}: returned {out!r}, "
                                 f"expected {expect.__name__} to be raised")
        shown = f"raised {type(out).__name__}: {out}"
    else:
        if out != expect or type(out) is not type(expect):
            raise AssertionError(f"[faults] {label}: returned {out!r}, expected {expect!r}")
        shown = f"returned {out!r}"
    if got != expect_deltas:
        raise AssertionError(f"[faults] {label}: counter deltas {got}, expected {expect_deltas}")
    log(f"[faults] {label}: {shown} in {seconds:.3f} s; counter deltas {got}")


def phase_faults(cuda_fq, kzg, blobs, commitments, proofs, device: str = "cuda") -> None:
    """The supervisor's routes on the card at small size (see the module
    docstring).  On the card no failure is answered by the host: a failed,
    hung or breaker-refused batch raises into the caller, so no case may
    move the host-fallback counter."""
    import threading

    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.ops.verify import verify_signature_sets_device
    from lighthouse_tpu_torch.workload import committee_sets

    def verify(sets):
        return verify_signature_sets_device(sets, device=device)

    four, two, one = (committee_sets(n, 1, seed=70 + n) for n in (4, 2, 1))
    for sets in (four, two, one):  # first dispatch of each shape, unfaulted
        if verify(sets) is not True:
            raise AssertionError("[faults] warm-up batch did not verify")

    def split_retry():
        fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
        return verify(four)

    fault_case("device.dispatch error first_n=1 on 4 x 1: split retry on the card",
               split_retry, True, {"split_retries": {"op=bls_verify,outcome=success": 1.0}})

    def hang():
        ds.SUPERVISOR.configure(deadlines={"bls_verify": HANG_DEADLINE_S})
        fi.install("device.dispatch", "hang", op="bls_verify", sleep_s=HANG_SLEEP_S, first_n=1)
        try:
            return verify(two)
        finally:
            ds.SUPERVISOR.configure(deadlines={"bls_verify": ds.DEFAULT_DEADLINES["bls_verify"]})
            # The abandoned worker wakes and finishes its batch on the
            # card; let it, before a later case installs another plan.
            for t in threading.enumerate():
                if t.name == "device-dispatch-bls_verify":
                    t.join(60.0)

    fault_case(f"hang {HANG_SLEEP_S} s past a {HANG_DEADLINE_S} s deadline on 2 x 1: "
               "watchdog, DispatchTimeout raised to the caller", hang, ds.DispatchTimeout,
               {"dispatch_timeouts": {"op=bls_verify": 1.0}})

    clock = [0.0]
    ds.set_cooldown_clock(lambda: clock[0])
    ds.SUPERVISOR.configure(config=ds.BreakerConfig(
        failure_threshold=2, open_cooldown_s=30.0, probe_successes=2))
    br = ds.SUPERVISOR.breaker("bls_verify")

    def trip():
        fi.install("device.dispatch", "error", op="bls_verify")
        raised = []
        for _ in range(2):  # 1-set batches cannot split
            try:
                verify(one)
            except fi.InjectedFault as err:
                raised.append(type(err).__name__)
        if br.state != "open":
            raise AssertionError(f"[faults] breaker {br.state} after 2 errors")
        return raised

    fault_case("device.dispatch errors to the threshold (2) on 1 x 1: each raised, OPEN",
               trip, ["InjectedFault", "InjectedFault"],
               {"split_retries": {"op=bls_verify,outcome=failure": 2.0},
                "breaker_transitions": {"op=bls_verify,to=open": 1.0}})

    def refused():
        launches = dict(cuda_fq.LAUNCHES)
        try:
            return verify(one)
        finally:
            if dict(cuda_fq.LAUNCHES) != launches:
                raise AssertionError("[faults] an OPEN breaker let the batch reach the card")

    fault_case("OPEN: RequeueWork raised, card untouched", refused, ds.RequeueWork, {})

    def recover():
        clock[0] += 31.0
        ok = verify(one)
        if br.state != "half_open":
            raise AssertionError(f"[faults] breaker {br.state} after one probe")
        ok = ok and verify(one)
        if br.state != "closed":
            raise AssertionError(f"[faults] breaker {br.state} after two probes")
        return ok

    fault_case("cooldown elapsed: two HALF_OPEN probes on the card, CLOSED", recover, True,
               {"breaker_transitions": {"op=bls_verify,to=half_open": 1.0,
                                        "op=bls_verify,to=closed": 1.0}})
    ds.SUPERVISOR.configure(config=ds.BreakerConfig.from_env())
    ds.set_cooldown_clock(None)

    def corrupt():
        fi.install("device.result", "corrupt", op="bls_verify", first_n=1)
        return verify(one)

    fault_case("device.result corrupt on 1 x 1: verdict False", corrupt, False, {})
    if verify(one) is not True:
        raise AssertionError("[faults] the batch after the corrupt one did not verify")

    def kzg_error():
        fi.install("device.dispatch", "error", op="kzg_batch")
        return kzg.verify_blob_kzg_proof_batch(blobs[:2], commitments[:2], proofs[:2])

    fault_case("kzg_batch device.dispatch error on 2 blobs: no split, raised to the caller",
               kzg_error, fi.InjectedFault, {})
    if kzg.verify_blob_kzg_proof_batch(blobs[:2], commitments[:2], proofs[:2]) is not True:
        raise AssertionError("[faults] the KZG batch after the faulted one did not verify")
    phase_hash_faults(device)
    phase_epoch_faults(device)
    phase_block_faults(device)
    phase_requeue_faults(device)
    for op in ("bls_verify", "kzg_batch", "sha256_pairs", "tree_hash", "epoch_boundary"):
        if ds.breaker_state(op) != "closed":
            raise AssertionError(f"[faults] the {op} breaker is left open")


def phase_hash_faults(device: str = "cuda") -> None:
    """The hashing ops' supervisor routes on the card, each with its exact
    counter deltas, none reaching the host."""
    import hashlib
    import threading

    import numpy as np

    from lighthouse_tpu_torch import device_pipeline
    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.ops import sha256_device as sd
    from lighthouse_tpu_torch.ops import tree_hash as th

    rng = np.random.default_rng(0xFA17)
    data = rng.integers(0, 256, 1000 * 64, dtype=np.uint8).tobytes()
    digests = b"".join(hashlib.sha256(data[i:i + 64]).digest() for i in range(0, len(data), 64))
    chunks = rng.integers(0, 256, (4 * th.SUBTREE_LEAVES, 32), dtype=np.uint8)
    golden = [th._words_to_chunks(lv) for lv in th._host_subtree_levels(th._chunks_to_words(chunks))]
    th.configure(device=device)
    # first dispatch of each shape, unfaulted
    if sd.hash_pairs_device(data, device=device) != digests:
        raise AssertionError("[faults] sha256_pairs warm-up != hashlib")
    th.hash_subtree_levels(chunks)

    def levels_equal(levels) -> bool:
        return all(np.array_equal(a, b) for a, b in zip(levels, golden))

    def sha_split():
        fi.install("device.dispatch", "error", op="sha256_pairs", first_n=1)
        return sd.hash_pairs_device(data, device=device) == digests

    fault_case("sha256_pairs device.dispatch error first_n=1 on 1,000 blocks: split retry on "
               "the card, digests equal hashlib", sha_split, True,
               {"split_retries": {"op=sha256_pairs,outcome=success": 1.0}})

    def tree_split():
        fi.install("device.dispatch", "error", op="tree_hash", first_n=1)
        return levels_equal(th.hash_subtree_levels(chunks))

    fault_case("tree_hash device.dispatch error first_n=1 on 4 subtrees: split retry on the "
               "card, levels equal the golden", tree_split, True,
               {"split_retries": {"op=tree_hash,outcome=success": 1.0}})

    def tree_hang():
        ds.SUPERVISOR.configure(deadlines={"tree_hash": HANG_DEADLINE_S})
        fi.install("device.dispatch", "hang", op="tree_hash", sleep_s=HANG_SLEEP_S, first_n=1)
        try:
            return th.hash_subtree_levels(chunks)
        finally:
            ds.SUPERVISOR.configure(deadlines={"tree_hash": ds.DEFAULT_DEADLINES["tree_hash"]})
            for t in threading.enumerate():
                if t.name == "device-dispatch-tree_hash":
                    t.join(60.0)

    fault_case(f"tree_hash hang {HANG_SLEEP_S} s past a {HANG_DEADLINE_S} s deadline on 4 "
               "subtrees: watchdog, DispatchTimeout raised to the caller", tree_hang,
               ds.DispatchTimeout, {"dispatch_timeouts": {"op=tree_hash": 1.0}})

    def pipeline_error():
        device_pipeline.enable(device=device)
        pipe = device_pipeline.get_hash_pipeline()
        pipe.linger_s = RUNTIME_LINGER_S
        host_calls = []
        real_host = sd._host_hash_pairs
        sd._host_hash_pairs = lambda d: host_calls.append(len(d)) or real_host(d)
        fi.install("device.dispatch", "error", op="sha256_pairs")
        try:
            futures = [pipe.submit(data[:500 * 64]), pipe.submit(data[500 * 64:])]
            raised = []
            for fut in futures:
                try:
                    fut.result(timeout=120.0)
                except fi.InjectedFault as err:
                    raised.append(type(err).__name__)
            batch = pipe.snapshot()["recent_batches"][-1]
        finally:
            sd._host_hash_pairs = real_host
            device_pipeline.shutdown()
        if (batch["n_groups"], batch["group_rehashes"], batch["group_errors"]) != (2, 0, 2):
            raise AssertionError(f"[faults] hash pipeline batch {batch}")
        if host_calls:
            raise AssertionError(f"[faults] the host kernel re-hashed {host_calls}")
        return raised

    fault_case("sha256_pairs error on every dispatch under the hash pipeline (2 groups): the "
               "split fails, both futures raise, nothing re-hashed on the host",
               pipeline_error, ["InjectedFault", "InjectedFault"],
               {"split_retries": {"op=sha256_pairs,outcome=failure": 1.0}})
    if sd.hash_pairs_device(data, device=device) != digests:
        raise AssertionError("[faults] the sha256_pairs batch after the faults != hashlib")


# ------------------------------------------------------------ the epoch slice


def walk_reference(seeds, m: int, k: int) -> "np.ndarray":
    """The spec's compute_shuffled_index of each (slot, candidate) lane's
    start, host Python: the positions the proposer walk must end at."""
    import numpy as np

    from lighthouse_tpu_torch.consensus.shuffling import compute_shuffled_index

    return np.array([[compute_shuffled_index(c % m, m, seed, SHUFFLE_ROUNDS) for c in range(k)]
                     for seed in seeds], dtype=np.int32)


def phase_epoch_kernels() -> dict:
    """Both epoch kernels against their plain versions on the card at each
    registry bucket up to 2^20 (and one below it), and against the host:
    the shuffle against ``shuffle_list`` up to EPOCH_HOST_MAX lanes and at
    the top bucket, the walk against the scalar ``compute_shuffled_index``
    at every size."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.consensus.shuffling import shuffle_list
    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import shuffle_device as psd

    max_err = {"shuffle_round": 0, "proposer_walk": 0}
    k = psd.PROPOSER_CANDIDATES
    for n in EPOCH_NS:
        t0 = time.perf_counter()
        nb = psd._bucket(n)
        seed = hashlib.sha256(b"epoch-kernels-%d" % n).digest()
        values = np.random.default_rng(n).permutation(nb).astype(np.int32)
        pivots, digests = psd.shuffle_tables(seed, SHUFFLE_ROUNDS, n, nb)
        x, pv, dg = (torch.from_numpy(a).cuda() for a in (values, pivots, digests))
        got = cuda_epoch.shuffle_rounds(x, pv, dg, n)
        want = cuda_epoch.shuffle_rounds_plain(x, pv, dg, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err["shuffle_round"] = max(max_err["shuffle_round"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"shuffle_round n={n}: kernel != plain (max err {err})")
        host = ""
        if n <= EPOCH_HOST_MAX or n == nb == EPOCH_NS[-1]:
            if not np.array_equal(got[:n].cpu().numpy(), shuffle_list(values[:n], seed,
                                                                       SHUFFLE_ROUNDS)):
                raise AssertionError(f"shuffle_round n={n}: != shuffle_list")
            host = "; equals shuffle_list"
        seeds = [hashlib.sha256(b"walk-%d-%d" % (n, s)).digest() for s in range(EPOCH_SLOTS)]
        seed_words, walk_pivots, _ = psd.proposer_tables(seeds, SHUFFLE_ROUNDS, n)
        sw = torch.from_numpy(seed_words.view(np.int32)).cuda()
        wp = torch.from_numpy(walk_pivots).cuda()
        walk = cuda_epoch.proposer_walk(sw, wp, k, n)
        torch.cuda.synchronize()
        ref = walk_reference(seeds, n, k)
        err = int(np.abs(walk.cpu().numpy().astype(np.int64) - ref).max())
        max_err["proposer_walk"] = max(max_err["proposer_walk"], err)
        if err:
            raise AssertionError(f"proposer_walk m={n}: != compute_shuffled_index (max err {err})")
        plain = ""
        if n in (EPOCH_NS[2], EPOCH_NS[-1]):
            for rounds in WALK_CHECK_ROUNDS:
                if rounds == SHUFFLE_ROUNDS:
                    tables = (sw, wp)
                else:
                    sw_r, wp_r, _ = psd.proposer_tables(seeds, rounds, n)
                    tables = (torch.from_numpy(sw_r.view(np.int32)).cuda(),
                              torch.from_numpy(wp_r).cuda())
                want = cuda_epoch.proposer_walk_plain(*tables, k, n)
                for look in (None,) + cuda_epoch.WALK_LOOKAHEADS:
                    got = cuda_epoch._proposer_walk_k(*tables, k, n, look)
                    if not torch.equal(got, want):
                        raise AssertionError(f"proposer_walk m={n} R={rounds} lookahead={look}: "
                                             f"kernel != plain")
            plain = (f" and its plain version at every lookahead of "
                     f"{cuda_epoch.WALK_LOOKAHEADS} and {WALK_CHECK_ROUNDS} rounds")
        log(f"[epoch-kernels] n={n} (bucket {nb}): shuffle_round x{SHUFFLE_ROUNDS} equals its "
            f"plain version{host}; proposer_walk {EPOCH_SLOTS} x {k} lanes (lookahead "
            f"{cuda_epoch.walk_lookahead()}) equals compute_shuffled_index{plain}; "
            f"{time.perf_counter() - t0:.2f} s")
    max_err["shuffle_round"] = max(max_err["shuffle_round"], shuffle_block_check())
    return max_err


def shuffle_block_check() -> int:
    """shuffle_round's block form on the card (one launch over ``count``
    lanes from ``offset``, reading the whole list: a mesh shard's part of a
    round) against its plain version and the whole-list round's slice, at
    the SHUFFLE_BLOCK_NS live counts: the two halves, a block across the
    live count, and a block made only of padding (which must pass through).
    Returns the largest difference (0)."""
    import hashlib

    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import shuffle_device as psd

    worst = 0
    for n in SHUFFLE_BLOCK_NS:
        t0 = time.perf_counter()
        nb = psd._bucket(n)
        pad = (nb - n) // 2
        blocks = [(0, nb // 2), (nb // 2, nb - nb // 2), (n - 12, 24), (nb - pad, pad)]
        seed = hashlib.sha256(b"shuffle-blocks-%d" % n).digest()
        values = torch.from_numpy(np.random.default_rng(n).permutation(nb).astype(np.int32))
        pivots, digests = psd.shuffle_tables(seed, SHUFFLE_ROUNDS, n, nb)
        x = values.cuda()
        for r in SHUFFLE_BLOCK_ROUNDS:
            one = (torch.from_numpy(pivots[r:r + 1]).cuda(),
                   torch.from_numpy(digests[r:r + 1]).cuda())
            whole = cuda_epoch.shuffle_rounds(x, *one, n)
            for offset, count in blocks:
                got = cuda_epoch.shuffle_rounds(x, *one, n, offset, count)
                want = cuda_epoch.shuffle_rounds_plain(x, *one, n, offset, count)
                err = int((got.long() - want.long()).abs().max()) if count else 0
                worst = max(worst, err)
                if not (torch.equal(got, want) and torch.equal(got, whole[offset:offset + count])):
                    raise AssertionError(f"shuffle_round block ({offset}, {count}) of n={n} "
                                         f"round {r}: != its plain version or the whole round")
                if offset >= n and not torch.equal(got, x[offset:offset + count]):
                    raise AssertionError(f"shuffle_round padding block ({offset}, {count}) of "
                                         f"n={n} moved")
        torch.cuda.synchronize()
        log(f"[epoch-kernels] shuffle_round's block form at n={n} (bucket {nb}): blocks "
            f"{blocks} (the halves, one across the live count, one of padding only) in rounds "
            f"{SHUFFLE_BLOCK_ROUNDS} equal the plain version's and the whole round's slice; "
            f"the padding block passes through; {time.perf_counter() - t0:.2f} s")
    return worst


def reference_duties(state, spec, epoch: int) -> tuple:
    """(shuffling, proposers) of ``epoch`` by the spec's host functions:
    the committee cache's numpy shuffle and the scalar proposer walk over
    the active set computed once."""
    from lighthouse_tpu_torch.consensus import helpers as h

    cache = h.CommitteeCache(state, epoch, spec)
    base = h.get_seed(state, epoch, h.DOMAIN_BEACON_PROPOSER, spec)
    proposers = [h.compute_proposer_index(state, cache.active_indices,
                                          h.hash(base + h.uint_to_bytes(slot)), spec)
                 for slot in range(epoch * spec.slots_per_epoch,
                                   (epoch + 1) * spec.slots_per_epoch)]
    return cache, proposers


def phase_epoch(card: str, device: str = "cuda", validators: int = EPOCH_VALIDATORS,
                leak_validators: int = EPOCH_LEAK_VALIDATORS) -> dict:
    """The epoch boundary at mainnet width: a Deneb mainnet-preset state
    one slot before a boundary crosses it through ``process_slots`` on the
    card with the fused boundary, out of an inactivity leak at
    ``validators`` and in one at ``leak_validators`` (a state of its own);
    each result equals a numpy-backend run of the port on the state itself
    (the card runs on a copy): balances, inactivity, validator fields,
    proposers, committees, state root, with no host fallback.  First the
    staged deltas program once against the numpy pass; the kernels' launch
    counts are set to 0 just before the first boundary on the card and
    read just after the last."""
    import numpy as np

    from lighthouse_tpu_torch import device_telemetry
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.types.spec import mainnet_spec
    from lighthouse_tpu_torch.workload import boundary_state, clone_state

    spec = mainnet_spec()
    t0 = time.perf_counter()
    base, types = boundary_state(validators, seed=0xE90C, leak=False)
    build_s = time.perf_counter() - t0
    target = base.slot + 1
    next_epoch = target // spec.slots_per_epoch
    log(f"[epoch] Deneb mainnet-preset state with {len(base.validators)} validators one slot "
        f"before epoch {next_epoch} built from a seed in {build_s:.2f} s")
    fields = ("effective_balance", "activation_eligibility_epoch", "activation_epoch",
              "exit_epoch", "withdrawable_epoch", "slashed")
    staged_out = staged_deltas(base, spec, next_epoch, device)
    t0 = time.perf_counter()
    leak_base, _ = boundary_state(leak_validators, seed=0xE90C, leak=True)
    log(f"[epoch] the leak boundary's state with {len(leak_base.validators)} validators built "
        f"from the same seed in {time.perf_counter() - t0:.2f} s")
    bases = {False: base, True: leak_base}
    del base, leak_base
    plans = []
    real_run = pe._run_boundary

    def recording_run(plan, *, in_leak):
        plans.append((plan, in_leak))
        return real_run(plan, in_leak=in_leak)

    pe._run_boundary = recording_run
    runs = {}
    start = runtime_mark()
    cuda_epoch.reset_launch_counts()
    try:
        for leak in (False, True):
            label = "leak" if leak else "no leak"
            # The numpy run takes the mode's state itself.
            ref_state = bases.pop(leak)
            before = {name: [getattr(v, name) for v in ref_state.validators] for name in fields}
            t = time.perf_counter()
            card_state = clone_state(ref_state)
            copy_s = time.perf_counter() - t

            th.configure(enabled=True, device=device)
            pe.configure(backend="device", fused_boundary=True, device=device)
            mark = runtime_mark()
            t = time.perf_counter()
            card_out = per_slot.process_slots(card_state, target, types, spec)
            card_s = time.perf_counter() - t
            records = assert_on_device(f"[epoch] {label}", mark)
            ops = [r["op"] for r in records]
            op = "epoch_boundary_leak" if leak else "epoch_boundary"
            boundary = [r for r in records if r["op"] == op]
            if len(boundary) != 1:
                raise AssertionError(f"[epoch] {label}: flight records {ops}")
            st = boundary[0]["stages_s"]
            dev_s = st["dispatch"] + st["wait"]
            hash_s = device_seconds([r for r in records if r["op"] in ("sha256_pairs", "tree_hash")])
            if pe.is_in_inactivity_leak(card_out, spec) is not leak:
                raise AssertionError(f"[epoch] {label}: leak mode is not {leak}")
            t = time.perf_counter()
            card_root = card_out.hash_tree_root()
            card_root_s = time.perf_counter() - t

            th.configure(enabled=False)
            pe.configure(backend="numpy")
            t = time.perf_counter()
            ref_out = per_slot.process_slots(ref_state, target, types, spec)
            ref_s = time.perf_counter() - t
            t = time.perf_counter()
            ref_root = ref_out.hash_tree_root()
            ref_root_s = time.perf_counter() - t

            t = time.perf_counter()
            if list(card_out.balances) != list(ref_out.balances):
                raise AssertionError(f"[epoch] {label}: balances != numpy run")
            if list(card_out.inactivity_scores) != list(ref_out.inactivity_scores):
                raise AssertionError(f"[epoch] {label}: inactivity != numpy run")
            changed = {}
            for name in fields:
                a = [getattr(v, name) for v in card_out.validators]
                if a != [getattr(v, name) for v in ref_out.validators]:
                    raise AssertionError(f"[epoch] {label}: validator {name} != numpy run")
                changed[name] = sum(x != y for x, y in zip(a, before[name]))
            cache, proposers = reference_duties(ref_out, spec, next_epoch)
            primed = h._caches(card_out)
            card_cache = primed["committees"][next_epoch]
            if not (np.array_equal(card_cache.shuffling, cache.shuffling)
                    and np.array_equal(card_cache.active_indices, cache.active_indices)
                    and card_cache.committees_per_slot == cache.committees_per_slot):
                raise AssertionError(f"[epoch] {label}: committees != numpy run")
            card_proposers = [h.get_beacon_proposer_index(card_out, spec, slot)
                              for slot in range(target, target + spec.slots_per_epoch)]
            if card_proposers != proposers:
                raise AssertionError(f"[epoch] {label}: proposers != numpy run")
            if card_root != ref_root:
                raise AssertionError(f"[epoch] {label}: state root != numpy run")
            check_s = time.perf_counter() - t
            runs[label] = {
                "validators": len(before["slashed"]), "card_s": card_s, "device_s": dev_s, "host_s": card_s - dev_s - hash_s,
                "hash_device_s": hash_s, "numpy_s": ref_s, "card_root_s": card_root_s,
                "numpy_root_s": ref_root_s, "copy_s": copy_s, "check_s": check_s,
                "stages_s": st, "changed": changed, "records": ops,
                "primed_proposers": len(primed.get("proposers", {})),
            }
            log(f"[epoch] {card}, {label}, {len(before['slashed'])} validators: process_slots "
                f"across the boundary on the card "
                f"{card_s:.2f} s (boundary program {dev_s:.4f} s on the flight record: dispatch "
                f"{st['dispatch']:.4f} s, wait {st['wait']:.4f} s; tree hashing "
                f"{hash_s:.3f} s of device stages; host Python the rest), numpy-backend run "
                f"{ref_s:.2f} s; post-state roots {card_root_s:.2f} s (card) / {ref_root_s:.2f} s "
                f"(host); copies {copy_s:.2f} s, checks {check_s:.2f} s")
            log(f"[epoch] {label}: balances, inactivity, validator fields (changed {changed}), "
                f"{len(cache.shuffling)}-validator committees, {len(proposers)} proposers "
                f"({runs[label]['primed_proposers']} primed from the card) and the state root "
                f"equal the numpy run; flight records {ops}; no host fallback")
            del card_state, ref_state, card_out, ref_out
    finally:
        pe._run_boundary = real_run
        th.configure(enabled=False)
        pe.configure(backend="device", fused_boundary=True, device="cuda")
    launches = dict(cuda_epoch.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_epoch.SIZES.items()}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the [epoch] path")
    assert_on_device("[epoch]", start)
    log(f"[epoch] kernel launches over both boundaries {launches}, launch sizes {sizes}; "
        f"duty-cache priming {device_telemetry.boundary_prime_counts()}")

    return {"validators": runs["no leak"]["validators"], "build_s": build_s, "runs": runs,
            "launches": launches, "sizes": sizes, "plans": plans, **staged_out}


def staged_deltas(state, spec, next_epoch: int, device: str) -> dict:
    """The staged seam once: ``epoch_deltas_device`` on the card against the
    numpy pass, on ``state``'s registry as the boundary into ``next_epoch``
    sees it."""
    import numpy as np

    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import epoch_device

    arrays = pe.EpochArrays(state, spec)
    n = arrays.n
    prev_part = np.asarray(state.previous_epoch_participation, dtype=np.int64)
    inactivity = np.asarray(state.inactivity_scores, dtype=np.int64)
    total = max(spec.effective_balance_increment, int(
        arrays.effective_balance[arrays.active_mask(next_epoch - 1)].sum()))
    kwargs = dict(previous_epoch=next_epoch - 2, in_leak=False,
                  base_reward_per_increment=spec.effective_balance_increment
                  * spec.base_reward_factor // spec.integer_squareroot(total),
                  total_active_balance=total,
                  quotient=spec.inactivity_penalty_quotient_bellatrix, spec=spec)
    t = time.perf_counter()
    staged = epoch_device.epoch_deltas_device(arrays, prev_part, inactivity, device=device,
                                              **kwargs)
    staged_s = time.perf_counter() - t
    t = time.perf_counter()
    golden = pe._epoch_deltas_numpy(arrays, prev_part, inactivity, **kwargs)
    numpy_s = time.perf_counter() - t
    if not all(np.array_equal(a, b) for a, b in zip(staged, golden)):
        raise AssertionError("[epoch] staged epoch_deltas_device != _epoch_deltas_numpy")
    log(f"[epoch] staged epoch_deltas_device on {n} validators: {staged_s:.4f} s on the card, "
        f"equal to the numpy pass ({numpy_s:.4f} s on the host)")
    return {"deltas_args": (arrays, prev_part, inactivity, kwargs), "staged_s": staged_s,
            "deltas_numpy_s": numpy_s}


def plan_deltas_inputs(plan, leak: bool) -> tuple:
    """``epoch_deltas_device``'s arguments for a boundary plan's registry:
    ``(arrays, prev_part, inactivity, kwargs)``."""
    import types

    from lighthouse_tpu_torch.consensus import per_epoch as pe

    arrays = pe.EpochArrays.__new__(pe.EpochArrays)
    arrays.n = plan.n
    for name in ("effective_balance", "activation_epoch", "exit_epoch", "withdrawable_epoch",
                 "slashed"):
        setattr(arrays, name, getattr(plan, name))
    spec = types.SimpleNamespace(
        effective_balance_increment=plan.increment,
        inactivity_score_bias=plan.inactivity_score_bias,
        inactivity_score_recovery_rate=plan.inactivity_score_recovery_rate)
    kwargs = dict(previous_epoch=plan.previous_epoch, in_leak=leak,
                  base_reward_per_increment=plan.base_reward_per_increment,
                  total_active_balance=plan.total_active_balance, quotient=plan.quotient,
                  spec=spec)
    return arrays, plan.prev_part, plan.inactivity, kwargs


def phase_epoch_mesh(card: str, epoch_out: dict, device: str = "cuda") -> dict:
    """The epoch programs split across the device mesh: [epoch]'s two
    boundary plans (2^20 validators out of a leak, 2^16 in one; no new
    state) through ``epoch_boundary_device`` and ``epoch_deltas_device``,
    unsharded on the card and then on a mesh of MESH_DEVICES (two shards of
    the one card).  Every output of the split equals the unsharded run's
    and the numpy blocks'; its flight records carry mesh 2 and per-shard
    live rows summing to the registry; each shard launched
    ``shuffle_round`` once a round (``cuda_epoch.LAUNCHES``, counted apart
    by ``ShardLaunches``; counts set to 0 just before the split boundary,
    read just after) and the walk ran once, on the first member.  Logs the
    seconds of each run and the bytes of the shuffle's exchange, as
    ``shuffle_device.EXCHANGE_BYTES`` counts them where the split shuffle
    copies and gathers (set to 0 just before the split boundary)."""
    import numpy as np

    from lighthouse_tpu_torch import device_mesh, device_telemetry
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import cuda_epoch, epoch_device
    from lighthouse_tpu_torch.ops import shuffle_device as psd

    def same(a, b) -> bool:
        return all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)

    def record(op: str, n: int) -> dict:
        rec = device_telemetry.FLIGHT_RECORDER.recent(1, op=op)[0]
        if rec.get("mesh") != 2 or sum(rec.get("shard_live") or []) != n or \
                rec["host_fallback"]:
            raise AssertionError(f"[epoch] mesh: the {op} flight record {rec}")
        return rec

    runs = {}
    try:
        for plan, leak in epoch_out["plans"]:
            label = "leak" if leak else "no leak"
            op = "epoch_boundary_leak" if leak else "epoch_boundary"
            dop = "epoch_deltas_leak" if leak else "epoch_deltas"
            n, rounds = plan.n, plan.rounds
            deltas_args = plan_deltas_inputs(plan, leak)
            arrays, prev_part, inactivity, kwargs = deltas_args
            t = time.perf_counter()
            golden = pe._epoch_boundary_numpy(plan, in_leak=leak)
            dgolden = pe._epoch_deltas_numpy(arrays, prev_part, inactivity, **kwargs)
            numpy_s = time.perf_counter() - t
            device_mesh.configure("0")
            t = time.perf_counter()
            whole = psd.epoch_boundary_device(plan, in_leak=leak, device=device)
            whole_s = time.perf_counter() - t
            whole_st = device_telemetry.FLIGHT_RECORDER.recent(1, op=op)[0]["stages_s"]
            t = time.perf_counter()
            dwhole = epoch_device.epoch_deltas_device(arrays, prev_part, inactivity,
                                                      device=device, **kwargs)
            dwhole_s = time.perf_counter() - t
            if not (same(whole, golden) and same(dwhole, dgolden)):
                raise AssertionError(f"[epoch] mesh, {label}: the unsharded card run != numpy")
            if device_mesh.configure("auto", devices=MESH_DEVICES) != 2:
                raise AssertionError(f"[epoch] mesh over {MESH_DEVICES}: not two members")
            cuda_epoch.reset_launch_counts()
            psd.reset_exchange_bytes()
            with ShardLaunches(cuda_epoch.LAUNCHES, [(psd, "_shuffle_block_shard")]) as shards:
                t = time.perf_counter()
                split = psd.epoch_boundary_device(plan, in_leak=leak, device=device)
                split_s = time.perf_counter() - t
            launches = dict(cuda_epoch.LAUNCHES)
            exchange = dict(psd.EXCHANGE_BYTES)
            rec = record(op, n)
            t = time.perf_counter()
            dsplit = epoch_device.epoch_deltas_device(arrays, prev_part, inactivity,
                                                      device=device, **kwargs)
            dsplit_s = time.perf_counter() - t
            drec = record(dop, n)
            if not (same(split, whole) and same(split, golden)):
                bad = [i for i, (x, y) in enumerate(zip(split, whole)) if not np.array_equal(x, y)]
                raise AssertionError(f"[epoch] mesh, {label}: the split boundary's outputs {bad} "
                                     "!= the unsharded run's")
            if not (same(dsplit, dwhole) and same(dsplit, dgolden)):
                raise AssertionError(f"[epoch] mesh, {label}: the split deltas != unsharded")
            per_shard = {s: c["shuffle_round"] for s, c in sorted(shards.items())}
            if launches["shuffle_round"] != rounds * 2 or per_shard != {0: rounds, 1: rounds} \
                    or launches["proposer_walk"] != 1 or \
                    any(c["proposer_walk"] for c in shards.values()):
                raise AssertionError(f"[epoch] mesh, {label}: launches {launches}, per shard "
                                     f"{shards} (want {rounds} shuffle_round a shard, one walk "
                                     "on the first member)")
            rows = int(rec["shape"].split("@")[0])
            runs[label] = {"validators": n, "rows": rows, "numpy_s": numpy_s,
                           "boundary_s": whole_s, "boundary_split_s": split_s,
                           "deltas_s": dwhole_s, "deltas_split_s": dsplit_s,
                           "launches": launches, "shuffle_round_per_shard": per_shard,
                           "exchange_bytes": exchange, "shard_live": rec["shard_live"],
                           "stages_s": rec["stages_s"], "unsharded_stages_s": whole_st,
                           "deltas_stages_s": drec["stages_s"]}
            log(f"[epoch] {card}, mesh of {list(MESH_DEVICES)}, {label}, {n} validators: the "
                f"split boundary {split_s:.4f} s (unsharded {whole_s:.4f} s; flight record "
                f"{rec['shape']}, dispatch {rec['stages_s']['dispatch']:.4f} s, wait "
                f"{rec['stages_s']['wait']:.4f} s, unsharded {whole_st['dispatch']:.4f} s and "
                f"{whole_st['wait']:.4f} s; shard_live {rec['shard_live']}), the split "
                f"deltas {dsplit_s:.4f} s (unsharded {dwhole_s:.4f} s; {drec['shape']}); every "
                f"output equals the unsharded card run's and numpy's ({numpy_s:.2f} s on the "
                f"host); shuffle_round {per_shard} launches by shard ({rounds} rounds x 2), "
                f"proposer_walk {launches['proposer_walk']} on the first member; the exchange "
                f"counted {exchange['copied']} bytes copied to other members and "
                f"{exchange['gathered']} bytes gathered over {rounds} rounds")
    finally:
        device_mesh.configure("0")
    return runs


def phase_epoch_faults(device: str = "cuda") -> None:
    """One epoch_boundary fault on the card: a ``device.dispatch`` error on
    a 4,096-validator boundary raises into the caller, the numpy composite
    never runs, no counter moves (the op is never split), and the next
    boundary on the card equals the numpy run."""
    import copy

    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.types.spec import mainnet_spec
    from lighthouse_tpu_torch.workload import boundary_state

    spec = mainnet_spec()
    base, types = boundary_state(EPOCH_FAULT_VALIDATORS, seed=0xFA0C, leak=False)
    target = base.slot + 1
    th.configure(enabled=False)
    host_calls = []
    real_numpy = pe._epoch_boundary_numpy

    def spy(plan, **kw):
        host_calls.append(plan.n)
        return real_numpy(plan, **kw)

    def boundary(state):
        return per_slot.process_slots(state, target, types, spec)

    pe._epoch_boundary_numpy = spy
    try:
        pe.configure(backend="device", fused_boundary=True, device=device)
        boundary(copy.deepcopy(base))  # first dispatch of the shape, unfaulted

        def faulted():
            fi.install("device.dispatch", "error", op="epoch_boundary")
            return boundary(copy.deepcopy(base))

        fault_case(f"epoch_boundary device.dispatch error on a {EPOCH_FAULT_VALIDATORS}-validator "
                   "boundary: no split, raised to the caller, no numpy answer",
                   faulted, fi.InjectedFault, {})
        if host_calls:
            raise AssertionError(f"[faults] the numpy boundary answered on the card: {host_calls}")
        after = boundary(copy.deepcopy(base)).as_ssz_bytes()
        pe.configure(backend="numpy")
        if after != boundary(copy.deepcopy(base)).as_ssz_bytes():
            raise AssertionError("[faults] the boundary after the fault != the numpy run")
    finally:
        pe._epoch_boundary_numpy = real_numpy
        pe.configure(backend="device", fused_boundary=True, device="cuda")


def phase_requeue_faults(device: str = "cuda") -> None:
    """The beacon processor's requeue on the card: the bls_verify breaker
    opened by a fault plan, then an 8-attestation gossip batch of a
    HARNESS_VALIDATORS-validator harness (real crypto) through a
    ``LocalNode``'s processor (one worker) into its router's batch handler,
    drained as one batch.  Its verify raises ``RequeueWork`` (OPEN, no
    launch); the processor requeues each event once
    (``MAX_WORK_RETRIES``), the breaker's cooldown has elapsed by the
    retry (its clock reads the requeue counter), the retry is the
    HALF_OPEN probe: one batch on the card, True, every attestation applied,
    the breaker CLOSED; no host fallback, nothing dropped."""
    from lighthouse_tpu_torch import device_supervisor as ds
    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.crypto.bls import api, set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.ops import cuda_fq
    from lighthouse_tpu_torch.network import LocalNode
    from lighthouse_tpu_torch.network.transport import Hub
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.scheduler import W
    from lighthouse_tpu_torch.scheduler import processor as proc_mod
    from lighthouse_tpu_torch.scheduler.work import MAX_WORK_RETRIES

    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=False)
    node = None
    wt = W.GOSSIP_ATTESTATION
    try:
        hs = BeaconChainHarness(validator_count=HARNESS_VALIDATORS)
        (root,) = hs.extend_chain(1, attest=False)
        state, spec = hs.chain.get_state(root), hs.spec
        slot = int(state.slot)
        epoch = h.compute_epoch_at_slot(slot, spec)
        atts, voters = [], []
        for c in range(h.get_committee_count_per_slot(state, epoch, spec)):
            committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
            data = hs.chain.produce_attestation_data(slot, c)
            for pos, v in enumerate(committee):
                bits = [False] * len(committee)
                bits[pos] = True
                atts.append(hs.types.Attestation(
                    aggregation_bits=bits, data=data,
                    signature=hs.sign_attestation_data(state, data, v).to_bytes()))
                voters.append(v)
        if len(atts) != NET_TAMPERED:
            raise AssertionError(f"[faults] {len(atts)} attesters in slot {slot}")
        hs.advance_slot()
        node = LocalNode(hub=Hub(), peer_id="node", chain=hs.chain, max_workers=1)
        processor = node.processor
        items = [gossip_item(node.router.fork_digest, state, att, spec, "peer") for att in atts]
        def requeued():
            return proc_mod.WORK_EVENTS_REQUEUED.get(work=wt)

        base = requeued()
        ds.set_cooldown_clock(lambda: 31.0 if requeued() >= base + len(atts) else 0.0)
        ds.SUPERVISOR.configure(config=ds.BreakerConfig(
            failure_threshold=2, open_cooldown_s=30.0, probe_successes=1))
        one = [hs.chain.preverify_attestation(atts[0]).signature_set]

        def trip():
            fi.install("device.dispatch", "error", op="bls_verify")
            raised = []
            for _ in range(2):
                try:
                    api.verify_signature_sets(one)
                except fi.InjectedFault as err:
                    raised.append(type(err).__name__)
            if ds.breaker_state("bls_verify") != "open":
                raise AssertionError("[faults] the breaker is not open after 2 errors")
            return raised

        fault_case("device.dispatch errors to the threshold (2) on 1 x 1 before the gossip "
                   "batch: each raised, OPEN", trip, ["InjectedFault", "InjectedFault"],
                   {"split_retries": {"op=bls_verify,outcome=failure": 2.0},
                    "breaker_transitions": {"op=bls_verify,to=open": 1.0}})

        def requeue():
            counters = {"requeued": proc_mod.WORK_EVENTS_REQUEUED,
                        "processed": proc_mod.WORK_EVENTS_PROCESSED,
                        "dropped": proc_mod.WORK_EVENTS_DROPPED}
            before = {k: c.get(work=wt) for k, c in counters.items()}
            mark = runtime_mark()
            launches = dict(cuda_fq.LAUNCHES)
            with RoutedBatches(node) as handler:
                with HeldWorkers(processor):
                    for ev in gossip_events(node.router._process_gossip_attestations, items):
                        if not processor.send(ev):
                            raise AssertionError("[faults] a gossip send was refused")
                if not processor.wait_idle(NET_IDLE_S):
                    raise AssertionError("[faults] the processor did not drain")
            deltas = {k: c.get(work=wt) - before[k] for k, c in counters.items()}
            records = [(r["n_live"], r["verdict"]) for r in assert_on_device(
                "[faults] requeue", mark) if r["op"] == "bls_verify"]
            if deltas != {"requeued": len(atts) * MAX_WORK_RETRIES, "processed": len(atts),
                          "dropped": 0} or processor.metrics.dropped:
                raise AssertionError(f"[faults] processor deltas {deltas}, dropped "
                                     f"{processor.metrics.dropped}")
            if records != [(len(atts), True)] or dict(cuda_fq.LAUNCHES) == launches or \
                    [(b["n"], b["verdict"]) for b in handler.batches] != [(len(atts), True)]:
                raise AssertionError(f"[faults] requeue: records {records}, batches "
                                     f"{handler.batches}")
            log(f"[faults] requeue: the processor's deltas {deltas}; the retry's batch "
                f"{records} on the card")
            return sorted(handler.applied) == sorted(voters) and handler.raised == 1

        fault_case(f"OPEN, then {len(atts)} gossip attestations through a LocalNode's router: "
                   "RequeueWork, each event requeued once, the retry the HALF_OPEN probe on "
                   "the card, CLOSED, all applied", requeue, True,
                   {"breaker_transitions": {"op=bls_verify,to=half_open": 1.0,
                                            "op=bls_verify,to=closed": 1.0}})
    finally:
        if node is not None:
            node.shutdown()
        ds.SUPERVISOR.configure(config=ds.BreakerConfig.from_env())
        ds.set_cooldown_clock(None)
        torch_backend.reset_for_tests()


_SPANS_LOCK = threading.Lock()


def timed_calls(spans: dict, key: str, fn):
    """``fn`` wrapped to add its seconds to ``spans[key]`` (and count its
    calls under ``key + "_calls"``), from any thread."""
    def run(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            dt = time.perf_counter() - t
            with _SPANS_LOCK:
                spans[key] = spans.get(key, 0.0) + dt
                spans[key + "_calls"] = spans.get(key + "_calls", 0) + 1
    return run


class Patched:
    """Wrap attributes for the length of a ``with`` block: each ``(owner,
    name, key)`` by ``wrap`` (:func:`timed_calls`) under ``key``; the
    owner's own attribute (or its absence, where it was inherited) comes
    back after."""

    def __init__(self, spans: dict, targets, wrap=timed_calls):
        self.spans, self.targets, self.wrap = spans, list(targets), wrap

    def __enter__(self):
        self.saved = []
        for owner, name, key in self.targets:
            self.saved.append((owner, name, vars(owner).get(name, Patched)))
            setattr(owner, name, self.wrap(self.spans, key, getattr(owner, name)))
        return self.spans

    def __exit__(self, *exc):
        for owner, name, own in reversed(self.saved):
            if own is Patched:
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        return False


def span_seconds(trace) -> dict:
    """Seconds of each named span of ``trace`` (summed where a name repeats)."""
    out = {}

    def walk(sp):
        out[sp.name] = out.get(sp.name, 0.0) + sp.duration
        for child in sp.children:
            walk(child)

    walk(trace.root)
    return out


def block_case(validators: int = BLOCK_VALIDATORS, commitments=None) -> tuple:
    """The [block] and [chain] input: ``workload.block_import_case`` at
    ``validators`` from BLOCK_SEED, its block carrying ``commitments``;
    returns (case, seconds to build it)."""
    from lighthouse_tpu_torch.workload import block_import_case

    t0 = time.perf_counter()
    case = block_import_case(validators, seed=BLOCK_SEED, blob_commitments=commitments)
    return case, time.perf_counter() - t0


def phase_block(card: str, device: str = "cuda", validators: int = BLOCK_VALIDATORS,
                case=None, build_s: float = 0.0) -> dict:
    """Block import at mainnet width on the default device (see the module
    docstring), on ``case`` (:func:`block_case`, built here when None).
    The import applies the block to ``case.pre_state`` in place; the
    returned ``"anchor"`` is a copy taken before, after the warm root, so
    it carries the tree-hash cache ([chain]'s anchor).  The kernels' launch
    counts are set to 0 just before the import and read just after it."""
    import copy
    import sys

    import numpy as np

    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_block
    from lighthouse_tpu_torch.consensus.state_transition import StateRootMismatch, state_transition
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.fork_choice import ForkChoice
    from lighthouse_tpu_torch.ops import cuda_fq, cuda_sha
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.workload import clone_state, resign, warm_pubkey_cache

    st_mod = sys.modules["lighthouse_tpu_torch.consensus.state_transition"]
    if case is None:
        case, build_s = block_case(validators)
    pre, signed, types, spec = case.pre_state, case.signed_block, case.types, case.spec
    block = signed.message
    body = block.body
    slot = int(block.slot)
    block_root = block.hash_tree_root()
    parent_root = bytes(block.parent_root)
    att_keys = [sum(a.aggregation_bits) for a in body.attestations]
    log(f"[block] Deneb mainnet-preset state with {len(pre.validators)} validators at slot "
        f"{int(pre.slot)} and the block of slot {slot} built from a seed in {build_s:.2f} s "
        f"(host run without verification included): {len(body.attestations)} attestations "
        f"({min(att_keys)}-{max(att_keys)} keys, {sum(att_keys)} in all), sync bits "
        f"{sum(body.sync_aggregate.sync_committee_bits)}/{len(body.sync_aggregate.sync_committee_bits)}, "
        f"{len(body.proposer_slashings)} proposer slashing, {len(body.attester_slashings)} "
        f"attester slashing ({len(body.attester_slashings[0].attestation_1.attesting_indices)} "
        f"validators), {len(body.voluntary_exits)} exit, {len(body.bls_to_execution_changes)} "
        f"BLS change, {len(body.execution_payload.withdrawals)} withdrawals, "
        f"{len(body.execution_payload.transactions)} transactions, "
        f"{len(body.blob_kzg_commitments)} blob commitments, {len(body.deposits)} deposits; "
        f"{len(pre.eth1_data_votes)} eth1 votes in the state")

    t = time.perf_counter()
    keys = warm_pubkey_cache(case.keys)
    warm_keys_s = time.perf_counter() - t
    log(f"[block] pubkey cache warmed with the {keys} keys the block's signatures need, as "
        f"points in G1 by construction (a running node's validator pubkey cache; no "
        f"decompression or subgroup check) in {warm_keys_s:.2f} s, before the import")

    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=True, device=device)
    try:
        t = time.perf_counter()
        pre.hash_tree_root()
        warm_root_s = time.perf_counter() - t
        t = time.perf_counter()
        spare = clone_state(pre)
        copy_s = time.perf_counter() - t
        t = time.perf_counter()
        anchor = clone_state(pre)
        anchor_copy_s = time.perf_counter() - t
        t = time.perf_counter()
        fc = ForkChoice(spec=spec, genesis_block_root=parent_root, genesis_state=pre)
        anchor_s = time.perf_counter() - t
        log(f"[block] the state's tree-hash cache warmed by one full root on {card} in "
            f"{warm_root_s:.2f} s (untimed beside the import); a copy for the refusals "
            f"{copy_s:.2f} s, one for [chain]'s anchor {anchor_copy_s:.2f} s; fork choice "
            f"anchored at the state in {anchor_s:.2f} s")

        # The import, its host stages timed by wrapping the callees.
        verifier = per_block.BlockSignatureVerifier
        mark = runtime_mark()
        with Patched({}, [(st_mod, "process_slots", "process_slots"),
                          (st_mod, "per_block_processing", "per_block"),
                          (verifier, "include_all_signatures", "collect"),
                          (verifier, "verify", "verify")]) as spans:
            cuda_fq.reset_launch_counts()
            cuda_sha.reset_launch_counts()
            t = time.perf_counter()
            post = state_transition(pre, signed, types, spec)
            wall = time.perf_counter() - t
        launches = {**dict(cuda_fq.LAUNCHES), **dict(cuda_sha.LAUNCHES)}
        fq_sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
        sha_sizes = {name: dict(c) for name, c in cuda_sha.SIZES.items()}
        records = assert_on_device("[block]", mark)
        verifies = [r for r in records if r["op"] == "bls_verify"]
        if len(verifies) != 1:
            raise AssertionError(f"[block] {len(verifies)} bls_verify batches, expected one")
        batch = verifies[0]
        st = batch["stages_s"]
        if not all(k in st for k in ("setup", "dispatch", "wait")) or batch["verdict"] is not True:
            raise AssertionError(f"[block] the verify batch's record {batch}")
        verify_dev_s = st["dispatch"] + st["wait"]
        hashing = [r for r in records if r["op"] in ("sha256_pairs", "tree_hash")]
        hash_dev_s = device_seconds(hashing)
        for name in ("fq_mul", "fq2_mul", "sha256_pairs", "tree_hash_subtrees"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{name} was not launched during the block import")
        host = {"process_slots": spans["process_slots"], "collect": spans["collect"],
                "verify_setup": st["setup"],
                "operations": spans["per_block"] - spans["collect"] - spans["verify"],
                "root": wall - spans["process_slots"] - spans["per_block"]}
        log(f"[block] {card}: state_transition with VERIFY_BULK imported the block in "
            f"{wall:.3f} s; host: process_slots {host['process_slots']:.3f} s (its root "
            f"included), signature-set collection {host['collect']:.3f} s, the verify's setup "
            f"{host['verify_setup']:.3f} s, operations {host['operations']:.3f} s, the post-block "
            f"root {host['root']:.3f} s; device: the verify {verify_dev_s:.3f} s (dispatch "
            f"{st['dispatch']:.3f} s, wait {st['wait']:.3f} s, verdict {st['verdict']:.3f} s), "
            f"tree hashing {hash_dev_s:.3f} s over {len(hashing)} batches")
        log(f"[block] the verify: one supervised bls_verify batch on the card, bucket "
            f"{batch['shape']} ({batch['n_live']} sets), no host fallback, breakers closed; "
            f"kernel launches {launches}")

        # The host run's state: the root, the balances, the participation
        # flags and every field of every validator.
        t = time.perf_counter()
        ref = case.host_state
        if post.hash_tree_root() != bytes(block.state_root):
            raise AssertionError("[block] post-state root != the block's")
        if list(post.balances) != list(ref.balances):
            raise AssertionError("[block] balances != the host run's")
        for field in ("previous_epoch_participation", "current_epoch_participation"):
            if list(getattr(post, field)) != list(getattr(ref, field)):
                raise AssertionError(f"[block] {field} != the host run's")
        if len(post.validators) != len(ref.validators) or not all(
                a == b for a, b in zip(post.validators, ref.validators)):
            raise AssertionError("[block] a validator != the host run's")
        check_s = time.perf_counter() - t
        log(f"[block] the post-state's root is the block's (the host run's); its balances, "
            f"participation flags and the fields of its {len(post.validators)} validators "
            f"equal the host run's (checked in {check_s:.2f} s)")

        # Fork choice takes the block and its attestations.
        t = time.perf_counter()
        fc.on_block(current_slot=slot, block=block, block_root=block_root, state=post)
        attesters = []
        for att in body.attestations:
            indexed = h.get_indexed_attestation(post, att, types, spec)
            attesters.append(np.asarray(indexed.attesting_indices, dtype=np.int64))
            fc.on_attestation(
                current_slot=slot, attestation_slot=int(att.data.slot),
                attesting_indices=indexed.attesting_indices,
                beacon_block_root=bytes(att.data.beacon_block_root),
                target_epoch=int(att.data.target.epoch),
                target_root=bytes(att.data.target.root), is_from_block=True)
        head = fc.get_head(slot)
        fc_s = time.perf_counter() - t
        unique = np.unique(np.concatenate(attesters))
        eff = np.fromiter((post.validators[int(i)].effective_balance for i in unique),
                          dtype=np.int64, count=unique.size)
        weight = fc.proto.nodes[fc.proto.indices[parent_root]].weight
        if head != block_root:
            raise AssertionError("[block] fork choice's head is not the block")
        if weight != int(eff.sum()):
            raise AssertionError(f"[block] the anchor's weight {weight} != {int(eff.sum())}, the "
                                 "unique attesters' effective balances")
        log(f"[block] fork choice: on_block, {len(body.attestations)} on_attestation and "
            f"get_head in {fc_s:.3f} s; the head is the block; the anchor's weight {weight} "
            f"gwei equals the {unique.size} unique attesters' effective balances (numpy sum)")

        # Refusals, on the copy of the pre-state.
        message = copy.deepcopy(block)
        atts = message.body.attestations
        atts[0].signature, atts[1].signature = bytes(atts[1].signature), bytes(atts[0].signature)
        mark = runtime_mark()
        t = time.perf_counter()
        try:
            state_transition(spare, resign(case, message), types, spec)
        except per_block.BlockProcessingError as err:
            if str(err) != "bulk signature verification failed":
                raise
        else:
            raise AssertionError("[block] a swapped attestation signature was accepted")
        tampered_s = time.perf_counter() - t
        refused = [r for r in assert_on_device("[block] tampered", mark)
                   if r["op"] == "bls_verify"]
        if len(refused) != 1 or refused[0]["verdict"] is not False:
            raise AssertionError(f"[block] the tampered block's verify records {refused}")
        message = copy.deepcopy(block)
        root = bytearray(bytes(message.state_root))
        root[-1] ^= 0x01
        message.state_root = bytes(root)
        t = time.perf_counter()
        try:
            state_transition(spare, resign(case, message), types, spec)
        except StateRootMismatch:
            pass
        else:
            raise AssertionError("[block] a wrong state root was accepted")
        wrong_root_s = time.perf_counter() - t
        log(f"[block] refused on {card}: two attestation signatures swapped (re-signed by the "
            f"proposer): BlockProcessingError('bulk signature verification failed') in "
            f"{tampered_s:.2f} s, its batch's verdict False on the card; a state root off by "
            f"one byte (re-signed): StateRootMismatch in {wrong_root_s:.2f} s")
    finally:
        th.configure(enabled=False)
        torch_backend.reset_for_tests()
    return {"validators": len(pre.validators), "build_s": build_s, "warm_keys_s": warm_keys_s,
            "warm_root_s": warm_root_s, "wall_s": wall, "host_s": host,
            "verify_device_s": verify_dev_s, "hash_device_s": hash_dev_s,
            "stages_s": st, "bucket": batch["shape"], "sets": batch["n_live"],
            "launches": launches, "fq_sizes": fq_sizes, "sha_sizes": sha_sizes,
            "fork_choice_s": fc_s, "anchor_s": anchor_s, "tampered_s": tampered_s,
            "wrong_root_s": wrong_root_s, "anchor": anchor}


def phase_block_faults(device: str = "cuda") -> None:
    """One bls_verify fault on the block path: a ``device.dispatch`` error
    on the verify batch of a BLOCK_FAULT_VALIDATORS-validator block import
    (``workload.block_import_case``): one split retry, both halves on the
    card, the transition succeeds with the block's root, no host fallback."""
    import copy

    from lighthouse_tpu_torch import fault_injection as fi
    from lighthouse_tpu_torch.consensus.state_transition import state_transition
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.ops import verify
    from lighthouse_tpu_torch.workload import block_import_case, warm_pubkey_cache

    case = block_import_case(BLOCK_FAULT_VALIDATORS, seed=BLOCK_SEED + 1)
    warm_pubkey_cache(case.keys)
    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=False)
    halves = []
    real_subset = verify._device_verify_subset

    def subset(sets, seed, dev):
        halves.append((len(sets), dev.type))
        return real_subset(sets, seed, dev)

    verify._device_verify_subset = subset
    try:
        def faulted():
            fi.install("device.dispatch", "error", op="bls_verify", first_n=1)
            mark = runtime_mark()
            post = state_transition(copy.deepcopy(case.pre_state), case.signed_block,
                                    case.types, case.spec)
            assert_on_device("[faults] block", mark)
            return post.hash_tree_root() == bytes(case.signed_block.message.state_root)

        fault_case(f"device.dispatch error first_n=1 on a {BLOCK_FAULT_VALIDATORS}-validator "
                   "block's verify batch: split retry on the card, the block imports with "
                   "its root", faulted, True,
                   {"split_retries": {"op=bls_verify,outcome=success": 1.0}})
    finally:
        verify._device_verify_subset = real_subset
        torch_backend.reset_for_tests()
    n_sets = len(case.signed_block.message.body.attestations) + 9
    if sorted(halves) != sorted([(n_sets // 2, device), (n_sets - n_sets // 2, device)]):
        raise AssertionError(f"[faults] the block batch's halves {halves}")
    log(f"[faults] the block batch's halves {halves} ran on the {device} device")


def chain_snapshot(chain) -> dict:
    """What a refused import must leave as it was: the head, the store's key
    count (a lockbox file's or a MemoryStore's) and the chain's block
    caches."""
    store = chain.store
    keys = (int(store._lib.lockbox_count(store._h)) if hasattr(store, "_lib")
            else sum(len(col) for col in store._data.values()))
    return {"head": chain.head_root, "keys": keys,
            "blocks": sorted(chain._blocks), "states": sorted(chain._states),
            "observed": sorted(chain.observed_block_roots),
            "early": chain.early_attester_cache._item["block_root"]
            if chain.early_attester_cache._item else None,
            "fork_choice": len(chain.fork_choice.proto.indices)}


def sync_messages(case, chain, root: bytes, slot: int) -> list:
    """A SyncCommitteeMessage over ``root`` at ``slot`` from each member of
    the head state's sync committee, signed with the case's keys: one
    hash_to_g2 of the shared message, one G2 multiplication a member."""
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_SYNC_COMMITTEE
    from lighthouse_tpu_torch.workload import _Signer

    state, spec, types = chain.head_state, case.spec, case.types
    members = chain._sync_committee_member_indices(state)
    domain = h.get_domain(state, DOMAIN_SYNC_COMMITTEE, h.compute_epoch_at_slot(slot, spec), spec)
    message = h.compute_signing_root(root, domain)
    signer = _Signer()
    return [types.SyncCommitteeMessage(slot=slot, beacon_block_root=root, validator_index=v,
                                       signature=signer.sign(message, case.keys.secret[v]))
            for v in members]


class RoutedBatches:
    """Inside the block, each drained batch of ``node``'s router
    (``Router._process_gossip_attestations``) recorded on its worker
    thread: its items and kind, its candidates (the items that preverified
    and were not ignored), the sets of its first
    ``api.verify_signature_sets`` call and that call's verdict (the batch
    verify), the verdicts of the later calls (the per-item fallback), the
    seconds of its preverify, batch verify, apply and slasher calls, and the
    worker's trace id, which the batch's flight record carries.  Keeps each
    applied vote, each applied aggregate's aggregator, each item refused on
    its signature and each rejection (sender, reason).  A batch whose handler
    raises (``RequeueWork``) is counted in ``raised``, not recorded."""

    def __init__(self, node):
        self.node = node
        self.lock = threading.Lock()
        self.batches, self.applied, self.aggregated = [], [], []
        self.refused, self.rejected = [], []
        self.raised = 0
        self._local = threading.local()

    def _rec(self):
        return getattr(self._local, "rec", None)

    def _timed(self, key: str, fn, after=None):
        def run(*args, **kw):
            rec = self._rec()
            if rec is None or rec["depth"]:
                return fn(*args, **kw)
            rec["depth"] += 1
            t = time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                rec["depth"] -= 1
                rec[key] += time.perf_counter() - t
            if after is not None:
                after(rec, args, out)
            return out
        return run

    def __enter__(self):
        from lighthouse_tpu_torch import device_telemetry
        from lighthouse_tpu_torch.crypto.bls import api
        from lighthouse_tpu_torch.network import topics

        node, chain = self.node, self.node.chain
        router, slasher = node.router, node.slasher
        self.api, self.real_verify = api, api.verify_signature_sets
        self.saved = [(router, "_process_gossip_attestations"), (router, "_drain_slasher"),
                      (chain, "preverify_attestation"), (chain, "preverify_aggregate"),
                      (chain, "apply_attestation"), (chain, "apply_verified_aggregate"),
                      (node.service, "reject_gossip")]
        if slasher is not None:
            self.saved.append((slasher, "on_attestation"))
        self.saved = [(owner, name, owner.__dict__.get(name)) for owner, name in self.saved]
        handle = router._process_gossip_attestations
        aggregate_kind = topics.BEACON_AGGREGATE_AND_PROOF

        def batch(items):
            rec = {"items": len(items), "depth": 0, "cands": [], "singles": [],
                   "kind": "aggregate" if any(topics.GossipTopic.parse(it[0]).kind ==
                                              aggregate_kind for it in items) else "attestation",
                   "start": time.perf_counter(), "preverify_s": 0.0, "verify_s": 0.0,
                   "single_s": 0.0, "apply_s": 0.0, "slasher_s": 0.0}
            self._local.rec = rec
            try:
                handle(items)
            except BaseException:
                with self.lock:
                    self.raised += 1
                raise
            finally:
                self._local.rec = None
            rec["wall_s"] = time.perf_counter() - rec["start"]
            rec["n"] = len(rec["cands"])
            rec["trace_id"] = device_telemetry.active_trace_id()
            refused = ([c for c, ok in zip(rec["cands"], rec["singles"]) if not ok]
                       if rec.get("verdict") is False else [])
            with self.lock:
                self.batches.append(rec)
                self.refused += refused

        def candidate(rec, args, cand):
            v = [int(i) for i in cand.indexed.attesting_indices]
            epoch = int(args[0].data.target.epoch)
            if not (len(v) == 1 and slasher is None and chain.observed.attesters.is_known(
                    epoch, v[0])):
                rec["cands"].append(v[0] if len(v) == 1 else tuple(v))

        def aggregate_candidate(rec, args, cand):
            rec["cands"].append(int(args[0].message.aggregator_index))

        def verify(sets, *args, **kw):
            rec = self._rec()
            if rec is None or rec["depth"]:
                return self.real_verify(sets, *args, **kw)
            t = time.perf_counter()
            out = self.real_verify(sets, *args, **kw)
            if "verdict" not in rec:
                rec["verdict"], rec["sets"] = out, len(sets)
                rec["verify_s"] += time.perf_counter() - t
            else:
                rec["singles"].append(out)
                rec["single_s"] += time.perf_counter() - t
            return out

        def applied(rec, args, out):
            (v,) = (int(i) for i in args[0].indexed.attesting_indices)
            with self.lock:
                self.applied.append(v)

        def aggregated(rec, args, out):
            with self.lock:
                self.aggregated.append(int(args[0].signed_aggregate.message.aggregator_index))

        reject = node.service.reject_gossip

        def rejected(sender, topic, reason, *args, **kw):
            with self.lock:
                self.rejected.append((sender, reason))
            return reject(sender, topic, reason, *args, **kw)

        router._process_gossip_attestations = batch
        router._drain_slasher = self._timed("slasher_s", router._drain_slasher)
        chain.preverify_attestation = self._timed("preverify_s", chain.preverify_attestation,
                                                  candidate)
        chain.preverify_aggregate = self._timed("preverify_s", chain.preverify_aggregate,
                                                aggregate_candidate)
        chain.apply_attestation = self._timed("apply_s", chain.apply_attestation, applied)
        chain.apply_verified_aggregate = self._timed("apply_s", chain.apply_verified_aggregate,
                                                     aggregated)
        node.service.reject_gossip = rejected
        if slasher is not None:
            slasher.on_attestation = self._timed("slasher_s", slasher.on_attestation)
        api.verify_signature_sets = verify
        return self

    def __exit__(self, *exc):
        self.api.verify_signature_sets = self.real_verify
        for owner, name, value in self.saved:
            if value is None:
                delattr(owner, name)
            else:
                setattr(owner, name, value)
        return False


def gossip_item(digest: bytes, state, attestation, spec, sender: str) -> tuple:
    """``attestation`` as the router's gossip item: the topic of its subnet,
    its SSZ bytes, their snappy compression and the sender."""
    from lighthouse_tpu_torch.network import snappy_codec, topics

    subnet = topics.compute_subnet_for_attestation(
        state, int(attestation.data.slot), int(attestation.data.index), spec)
    raw = attestation.as_ssz_bytes()
    return (str(topics.attestation_subnet_topic(digest, subnet)), raw,
            snappy_codec.compress(raw), sender)


def gossip_events(handler, items: list) -> list:
    """Gossip ``items`` (the router's (topic, SSZ, compressed, sender)
    tuples) as ``WorkEvent``s, shaped as the router sends them: the item,
    the batch handler, a per-item path through it, dropped while
    syncing."""
    from lighthouse_tpu_torch.scheduler import W, WorkEvent

    return [WorkEvent(work_type=W.GOSSIP_ATTESTATION, process=lambda it: handler([it]),
                      process_batch=handler, item=item, drop_during_sync=True)
            for item in items]


class HeldWorkers:
    """Every worker of ``processor`` held by a gated ``STATUS`` event while
    the block runs, so that events sent in it queue up and drain as one
    batch when the gates open (as the JAX package's scheduler tests hold
    theirs)."""

    def __init__(self, processor):
        self.processor = processor

    def __enter__(self):
        from lighthouse_tpu_torch.scheduler import W, WorkEvent

        self.gate = threading.Event()
        started = [threading.Event() for _ in range(self.processor.max_workers)]
        for ev in started:
            self.processor.send(WorkEvent(
                work_type=W.STATUS,
                process=lambda _, ev=ev: (ev.set(), self.gate.wait(NET_IDLE_S))))
        for ev in started:
            if not ev.wait(30.0):
                raise AssertionError("a processor worker did not take its gated event")
        return self

    def __exit__(self, *exc):
        self.gate.set()
        return False


def committee_attestations(case, state, root: bytes, count: int, skip: int = 0,
                           points: dict = None) -> list:
    """Unaggregated attestations of ``state``'s slot for the head ``root``,
    as the block's aggregates vote (its slot, the committee's index, the
    state's justified checkpoint as source, the epoch's first block as
    target): from each committee, ``count`` distinct members after the
    first ``skip`` of them, in the order of their secret keys, each signed
    with its own key.  The members of a committee sign one message: one
    hash to G2 a committee, then each signature is the last one plus the
    message's point times the difference of the keys (their keys are
    consecutive integers, apart from validators between them that are not
    in the committee).  Returns (validator, attestation) pairs; ``points``,
    where given, holds each committee's hashed message, reused by a later
    call with the same dict."""
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.crypto.bls import curve, serde
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.bls.params import DST
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_ATTESTER

    types, spec, sk = case.types, case.spec, case.keys.secret
    slot = int(state.slot)
    epoch = h.compute_epoch_at_slot(slot, spec)
    if h.compute_start_slot_at_epoch(epoch, spec) != slot:
        raise ValueError("the target root is the head only at an epoch's first slot")
    domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, epoch, spec)
    out = []
    for c in range(h.get_committee_count_per_slot(state, epoch, spec)):
        committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
        position = {v: i for i, v in enumerate(committee)}
        members = sorted(committee, key=lambda v: sk[v])[skip:skip + count]
        data = types.AttestationData(
            slot=slot, index=c, beacon_block_root=root,
            source=state.current_justified_checkpoint,
            target=types.Checkpoint(epoch=epoch, root=root))
        point = points.get(c) if points is not None else None
        if point is None:
            point = hash_to_g2(h.compute_signing_root(data.hash_tree_root(), domain), DST)
        if points is not None:
            points[c] = point
        sig, key = None, 0
        for v in members:
            sig = curve.add(sig, curve.mul(point, sk[v] - key))
            key = sk[v]
            bits = [False] * len(committee)
            bits[position[v]] = True
            out.append((v, types.Attestation(aggregation_bits=bits, data=data,
                                             signature=serde.g2_compress(sig))))
    return out


class DispatchLaunches:
    """Inside the block, the Fq kernels' launches of each bls_verify
    batch's device stage, as (live sets, {kernel: launches}) in dispatch
    order: the supervisor runs one op's dispatches one at a time on its
    worker thread, so the counts of concurrent callers do not mix."""

    def __enter__(self):
        from lighthouse_tpu_torch.ops import cuda_fq, verify

        self.verify, self.real, self.dispatches = verify, verify._device_batch_verdict, []

        def counted(built, *args):
            before = dict(cuda_fq.LAUNCHES)
            try:
                return self.real(built, *args)
            finally:
                self.dispatches.append((len(built.sets), {
                    k: cuda_fq.LAUNCHES[k] - before[k] for k in before}))

        verify._device_batch_verdict = counted
        return self

    def __exit__(self, *exc):
        self.verify._device_batch_verdict = self.real
        return False


def committee_aggregates(case, state, signed: list, points: dict, nth: int = 0) -> list:
    """One ``SignedAggregateAndProof`` a committee of ``signed`` (the
    (validator, attestation) pairs of :func:`committee_attestations`, whose
    data's G2 points it left in ``points``): the aggregate of that
    committee's attestations in ``signed``, its aggregator the member first
    in the order of the secret keys whose selection proof passes
    ``is_aggregator``.  Every member of the slot signs one selection
    message: it is hashed to G2 once, and each next proof is the last one
    plus the point times the difference of the keys.  The aggregate's
    signature is the sum of its members' keys times the data's point; the
    outer signature one hash to G2 and one multiplication an aggregate.
    ``nth`` > 0 takes the committee's next aggregators in that order
    instead (a node observes one aggregate an aggregator and epoch).
    Returns (aggregator, signed aggregate) pairs in committee order."""
    import hashlib

    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.crypto.bls import curve, serde
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.bls.params import DST, R
    from lighthouse_tpu_torch.types.spec import (
        DOMAIN_AGGREGATE_AND_PROOF,
        DOMAIN_SELECTION_PROOF,
    )
    from lighthouse_tpu_torch.types.ssz import UintType
    from lighthouse_tpu_torch.workload import _Signer

    types, spec, sk = case.types, case.spec, case.keys.secret
    slot = int(state.slot)
    epoch = h.compute_epoch_at_slot(slot, spec)
    selection = hash_to_g2(h.compute_signing_root(
        UintType(8).hash_tree_root(slot),
        h.get_domain(state, DOMAIN_SELECTION_PROOF, epoch, spec)), DST)
    outer_domain = h.get_domain(state, DOMAIN_AGGREGATE_AND_PROOF, epoch, spec)
    by_committee = {}
    for v, att in signed:
        by_committee.setdefault(int(att.data.index), []).append((v, att))
    signer, out = _Signer(), []
    for c, members in sorted(by_committee.items()):
        committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
        modulo = max(1, len(committee) // spec.target_aggregators_per_committee)
        proof, key, aggregator, passed = None, 0, None, 0
        for v in sorted(committee, key=lambda v: sk[v]):
            proof = curve.add(proof, curve.mul(selection, sk[v] - key))
            key = sk[v]
            raw = serde.g2_compress(proof)
            if int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") % modulo == 0:
                passed += 1
                if passed > nth:
                    aggregator = v
                    break
        if aggregator is None:
            raise AssertionError(f"committee {c} has no aggregator number {nth + 1} at slot {slot}")
        position = {v: i for i, v in enumerate(committee)}
        bits = [False] * len(committee)
        for v, _ in members:
            bits[position[v]] = True
        data = members[0][1].data
        total = sum(sk[v] for v, _ in members) % R
        aggregate = types.Attestation(aggregation_bits=bits, data=data,
                                      signature=serde.g2_compress(curve.mul(points[c], total)))
        message = types.AggregateAndProof(aggregator_index=aggregator, aggregate=aggregate,
                                          selection_proof=raw)
        outer = signer.sign(h.compute_signing_root(message.hash_tree_root(), outer_domain),
                            sk[aggregator])
        out.append((aggregator, types.SignedAggregateAndProof(message=message, signature=outer)))
    return out


def wait_for(label: str, condition, timeout: float) -> float:
    """Poll ``condition`` until it holds; its seconds, or raise at
    ``timeout``."""
    t = time.perf_counter()
    while not condition():
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"{label}: timed out after {timeout:.0f} s")
        time.sleep(0.002)
    return time.perf_counter() - t


class NetworkCell:
    """The fabric around [chain]'s node for [wire] and [network]: the node
    (a ``LocalNode`` on the chain, its slasher on, the default BLS backend)
    and the publishing peer ``"pub"`` (a ``NetworkService`` subscribed to
    the 64 attestation subnets, the aggregate topic and the
    attester-slashing topic, answering the node's Status with the node's
    own).  On the hub (``wire=False``) both sit on a seeded ``Hub``.  On
    the wire both sit on secured ``TcpEndpoint``s on 127.0.0.1, the node
    with discv5 on under its Noise identity key, pub with its own
    ``Discv5Service``: pub bootstraps from the node's ENR, reads the node's
    record as the node serves it (FINDNODE at distance 0), dials its
    ``ip``/``tcp`` through multistream-select, Noise XX and yamux, and the
    cell waits until each side's mesh holds the other on every topic pub
    publishes to (:meth:`_dial`).  Times pub's sends and the node's
    service receipts (snappy, message id, the router's dispatch); keeps
    each message the node's service received, every gossip envelope the
    node sends to pub and every message pub receives."""

    def __init__(self, chain, slots_per_epoch: int, wire: bool = False):
        from lighthouse_tpu_torch.network import LocalNode, NetworkService, rpc, topics
        from lighthouse_tpu_torch.network.tcp_transport import TcpEndpoint
        from lighthouse_tpu_torch.network.transport import Hub
        from lighthouse_tpu_torch.slasher import SlasherConfig

        self.wire, self.hub, self.pub_discv5 = wire, None, None
        if wire:
            node_ep, pub_ep = TcpEndpoint("node", secured=True), TcpEndpoint("pub", secured=True)
        else:
            self.hub = Hub(seed=NET_SEED)
            node_ep, pub_ep = self.hub.register("node"), self.hub.register("pub")
        self.node = LocalNode(peer_id="node", chain=chain, endpoint=node_ep, max_workers=4,
                              enable_slasher=True,
                              slasher_config=SlasherConfig(history_length=SLASHER_HISTORY,
                                                           slots_per_epoch=slots_per_epoch))
        self.pub = NetworkService(pub_ep)
        self.spans, self.to_pub, self.received, self.got = (
            {"deliver": 0.0, "receive": 0.0}, [], [], [])
        node, pub = self.node, self.pub
        pub.on_gossip = lambda topic, raw, _c, sender: self.received.append((topic, raw, sender))
        pub.on_rpc_request = lambda protocol, _req, _sender: (
            [rpc.encode_response_chunk(rpc.SUCCESS, node.router.local_status().to_bytes())]
            if protocol == rpc.STATUS else [])
        digest = node.router.fork_digest
        self.subnet_topics = [str(topics.attestation_subnet_topic(digest, s))
                              for s in range(chain.spec.attestation_subnet_count)]
        self.aggregate_topic = str(topics.GossipTopic(digest, topics.BEACON_AGGREGATE_AND_PROOF))
        self.slashing_topic = str(topics.GossipTopic(digest, topics.ATTESTER_SLASHING))
        for topic in self.subnet_topics + [self.aggregate_topic, self.slashing_topic]:
            pub.subscribe(topic)
        pub.endpoint.send = timed_calls(self.spans, "deliver", pub.endpoint.send)
        on_gossip = node.service._on_gossip

        def receive(env):
            self.got.append((env.topic, env.data))
            return on_gossip(env)

        node.service._on_gossip = timed_calls(self.spans, "receive", receive)
        send = node.endpoint.send

        def node_send(peer, env):
            if peer == "pub" and env.kind == "gossip":
                self.to_pub.append(env.topic)
            return send(peer, env)

        node.endpoint.send = node_send
        wanted = set(self.subnet_topics + [self.aggregate_topic])
        if wire:
            self.wire_s = self._dial(wanted)
        else:
            self.hub.connect("node", "pub")

            def subscribed(service, peer, topics_):
                with service._mesh_lock:
                    return topics_ <= service.peer_topics.get(peer, set())

            wait_for("[network] subscriptions", lambda: subscribed(pub, "node", wanted) and
                     subscribed(node.service, "pub", {self.slashing_topic}), 60.0)
        if not node.wait_idle(60.0):
            raise AssertionError("the node's Status exchange did not finish")

    def _dial(self, wanted: set) -> dict:
        """[wire]'s discovery and connection (see the class docstring), with
        its gates: the node's record verifies, its ``ip``/``tcp`` are the
        node's listener and its key the node's Noise identity; each side's
        Noise-proven identity is the other's ENR key.  Returns the seconds
        of the lookup, of each step of the dialer's and the acceptor's
        handshake ladder, of the dial and of the meshes."""
        from lighthouse_tpu_torch.network.discv5 import Discv5Service, KeyPair, rlp, secp256k1
        from lighthouse_tpu_torch.network.discv5.enr import ENR
        from lighthouse_tpu_torch.network.noise import multistream, secure
        from lighthouse_tpu_torch.network.tcp_transport import TcpEndpoint

        node, pub = self.node, self.pub
        node_ep, pub_ep = node.endpoint, pub.endpoint
        node.enable_discv5(KeyPair(node_ep.identity_priv))
        self.pub_discv5 = Discv5Service(KeyPair(pub_ep.identity_priv)).start()
        boot = ENR.from_text(node.discv5.enr.to_text())  # as an operator hands it out
        out = {}
        t = time.perf_counter()
        table = self.pub_discv5.bootstrap(boot)
        served = [e for e in self.pub_discv5.find_node(boot, [0])
                  if e.node_id == node.discv5.node_id]
        out["lookup"] = time.perf_counter() - t
        if not served or node.discv5.node_id not in self.pub_discv5.table:
            raise AssertionError(f"[wire] pub's discv5 did not find the node (table {table})")
        enr = served[0]
        key = secp256k1.compress(secp256k1.pubkey(node_ep.identity_priv))
        if not enr.verify() or (enr.ip(), rlp.decode_uint(enr.pairs[b"tcp"])) != \
                tuple(node_ep.listen_addr) or enr.pairs[b"secp256k1"] != key:
            raise AssertionError(f"[wire] the node's record {enr} does not verify or does not "
                                 f"name its listener {node_ep.listen_addr} and its key")
        self.enr, self.listen = enr, tuple(node_ep.listen_addr)
        steps = {}

        def step_key(name):
            return lambda *a: f"{name} {a[1][0]}" if name == "negotiate" else name

        targets = [(multistream, "negotiate_outbound", step_key("negotiate")),
                   (multistream, "negotiate_inbound", step_key("negotiate")),
                   (secure, "secure_dial", step_key("noise_xx")),
                   (secure, "secure_accept", step_key("noise_xx")),
                   (TcpEndpoint, "_open_meshsub", step_key("meshsub_open"))]
        wanted_topics = sorted(wanted)

        def meshed():
            return all("node" in pub.mesh.get(tp, ()) and "pub" in node.service.mesh.get(tp, ())
                       for tp in wanted_topics)

        with Patched(steps, targets, wrap=role_timed):
            t = time.perf_counter()
            peer = pub_ep.dial(enr.ip(), rlp.decode_uint(enr.pairs[b"tcp"]))
            out["dial"] = time.perf_counter() - t
            out["connected"] = wait_for("[wire] the node's side of the connection",
                                        lambda: "pub" in node_ep.connected_peers(), 30.0)
        if peer != "node":
            raise AssertionError(f"[wire] pub dialled the node's record and reached {peer!r}")
        if pub_ep._peer_identities.get("node") != key or \
                node_ep._peer_identities.get("pub") != self.pub_discv5.enr.pairs[b"secp256k1"]:
            raise AssertionError("[wire] a Noise-proven identity is not the peer's ENR key")
        out["mesh"] = wait_for("[wire] the meshes", meshed, 60.0)
        out["steps"] = steps
        return out

    def attestation_topic(self, state, attestation, spec) -> str:
        from lighthouse_tpu_torch.network import topics

        subnet = topics.compute_subnet_for_attestation(
            state, int(attestation.data.slot), int(attestation.data.index), spec)
        return str(topics.attestation_subnet_topic(self.node.router.fork_digest, subnet))

    def publish(self, messages: list, work_type: str, label: str) -> tuple:
        """Publish (topic, SSZ bytes) ``messages`` from pub; returns the
        seconds of the publishing and until the node's service had handed
        every one to its processor."""
        received = self.node.processor.metrics.received
        before = received.get(work_type, 0)
        t = time.perf_counter()
        for topic, raw in messages:
            if not self.pub.publish(topic, raw):
                raise AssertionError(f"{label}: pub reached no peer with a message")
        published = time.perf_counter() - t
        wait_for(f"{label} handoff",
                 lambda: received.get(work_type, 0) - before == len(messages), NET_IDLE_S)
        return published, time.perf_counter() - t

    def shutdown(self) -> None:
        if self.node is not None:
            self.node.shutdown()
            self.pub.shutdown()
            if self.pub_discv5 is not None:
                self.pub_discv5.stop()
            if self.wire:
                self.pub.endpoint.close()
            self.node = None


def role_timed(spans: dict, key, fn):
    """``fn`` wrapped to add its seconds to ``spans["<role> <key(args)>"]``,
    the role ``dial`` on the main thread (where pub dials) and ``accept``
    on any other (the node's handshake threads)."""
    def run(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            role = "dial" if threading.current_thread() is threading.main_thread() else "accept"
            k, dt = f"{role} {key(*a)}", time.perf_counter() - t
            with _SPANS_LOCK:
                spans[k] = spans.get(k, 0.0) + dt
    return run


def wire_targets() -> list:
    """What [wire] times around its burst, process-wide (both ends):
    the native cipher's seal and open calls, yamux's frame sends (each
    with its Noise seal and socket write) and receipts (a frame's bytes
    into its stream), and meshsub's framing (an envelope into a protobuf
    frame; a frame's protobuf into envelopes)."""
    from lighthouse_tpu_torch import native
    from lighthouse_tpu_torch.network import pb, tcp_transport
    from lighthouse_tpu_torch.network.noise.yamux import YamuxSession, YamuxStream

    return [(native, "chacha20_poly1305_seal", "seal"),
            (native, "chacha20_poly1305_open", "open"),
            (YamuxSession, "_send_frame", "yamux_send"),
            (YamuxStream, "_on_data", "yamux_receive"),
            (tcp_transport, "_env_to_rpc", "meshsub_encode"),
            (pb, "encode_frame", "meshsub_encode"),
            (pb.RPC, "decode", "meshsub_decode"),
            (tcp_transport, "_rpc_to_envs", "meshsub_decode")]


def batch_records(label: str, routed, mark: dict, per_dispatch):
    """The batches ``routed`` recorded, each matched to its one bls_verify
    flight record since ``mark``, its trace's spans and its dispatch's Fq
    launches."""
    from lighthouse_tpu_torch import tracing

    records = [r for r in assert_on_device(label, mark) if r["op"] == "bls_verify"]
    by_trace = {r["trace_id"]: r for r in records if r["trace_id"] is not None}
    traces = {}
    for root in ("work:gossip_attestation", "work:gossip_aggregate"):
        for t_ in tracing.TRACES.recent(limit=64, root=root):
            traces[t_.trace_id] = span_seconds(t_)
    out = []
    for b in routed.batches:
        rec, sp = by_trace.get(b["trace_id"]), traces.get(b["trace_id"])
        if rec is None or sp is None or rec["n_live"] != b["sets"]:
            raise AssertionError(f"{label}: the batch of {b['items']} items has flight record "
                                 f"{rec and (rec['shape'], rec['n_live'])}, trace {sp is not None}")
        out.append((b, rec, sp, next(d for n, d in per_dispatch.dispatches if n == b["sets"])))
    return out, records


def gossip_burst(label: str, card: str, cell, routed, chain, spec, signed: list,
                 aggregates: list) -> dict:
    """pub publishes ``signed`` (the (validator, attestation) pairs of
    :func:`committee_attestations`) on their subnets, then ``aggregates``,
    each while the node's workers are held, and each drains into one
    batch and one supervised bls_verify batch on the card.  The gates:
    every vote in fork choice and every aggregate applied, every
    aggregator observed, nothing dropped, rejected or forwarded to pub,
    no slashing, no host fallback, both Fq kernels launched in the drain
    (counts set to 0 just before the first publish, read after the
    aggregates' drain), and the node's service received exactly the
    messages pub sent, in order, by topic and message id."""
    import numpy as np

    from lighthouse_tpu_torch import metrics
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.network import snappy_codec
    from lighthouse_tpu_torch.network.service import message_id
    from lighthouse_tpu_torch.ops import cuda_fq
    from lighthouse_tpu_torch.scheduler import W
    from lighthouse_tpu_torch.scheduler import processor as proc_mod

    node, state, root = cell.node, chain.head_state, chain.head_root
    epoch = h.compute_epoch_at_slot(int(state.slot), spec)
    voters = sorted(v for v, _ in signed)
    aggregators = [a for a, _ in aggregates]
    dropped0 = metrics_total(proc_mod.WORK_EVENTS_DROPPED)
    slashings0 = metrics_total(metrics.SLASHER_SLASHINGS)
    att_msgs = [(cell.attestation_topic(state, a, spec), a.as_ssz_bytes()) for _, a in signed]
    agg_msgs = [(cell.aggregate_topic, a.as_ssz_bytes()) for _, a in aggregates]
    got0, deliver0 = len(cell.got), dict(cell.spans)
    mark = runtime_mark()
    with DispatchLaunches() as per_dispatch:
        cuda_fq.reset_launch_counts()
        t0 = time.perf_counter()
        with HeldWorkers(node.processor):
            att_pub_s, att_handoff_s = cell.publish(att_msgs, W.GOSSIP_ATTESTATION,
                                                    f"{label} attestations")
        if not node.wait_idle(NET_IDLE_S):
            raise AssertionError(f"{label} the node did not drain the attestations")
        att_wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        with HeldWorkers(node.processor):
            agg_pub_s, agg_handoff_s = cell.publish(agg_msgs, W.GOSSIP_AGGREGATE,
                                                    f"{label} aggregates")
        if not node.wait_idle(NET_IDLE_S):
            raise AssertionError(f"{label} the node did not drain the aggregates")
        agg_wall = time.perf_counter() - t1
        launches = dict(cuda_fq.LAUNCHES)
    sizes = {name: dict(c) for name, c in cuda_fq.SIZES.items()}
    fabric = {k: v - deliver0.get(k, 0) for k, v in cell.spans.items()}
    sent = [(tp, message_id(raw)) for tp, raw in att_msgs + agg_msgs]
    got = [(tp, message_id(snappy_codec.decompress(data))) for tp, data in cell.got[got0:]]
    if got != sent:
        raise AssertionError(f"{label} the node's service received {len(got)} messages, "
                             f"{sum(a != b for a, b in zip(got, sent))} of them not pub's in "
                             f"order; pub sent {len(sent)}")
    matched, records = batch_records(label, routed, mark, per_dispatch)
    kinds = [(b["kind"], b["items"], b["sets"], b["verdict"]) for b, *_ in matched]
    if kinds != [("attestation", len(signed), len(signed), True),
                 ("aggregate", len(aggregates), 3 * len(aggregates), True)] or len(records) != 2:
        raise AssertionError(f"{label} batches {kinds}, records "
                             f"{[(r['shape'], r['n_live'], r['verdict']) for r in records]}")
    if sorted(routed.applied) != voters or sorted(routed.aggregated) != sorted(aggregators):
        raise AssertionError(f"{label} applied {len(routed.applied)} votes "
                             f"({len(set(routed.applied))} validators) and "
                             f"{len(routed.aggregated)} aggregates")
    if not all(chain.observed.aggregators.is_known(epoch, a) for a in aggregators):
        raise AssertionError(f"{label} an aggregator is not in observed.aggregators")
    if routed.rejected or routed.refused or routed.raised:
        raise AssertionError(f"{label} rejected {routed.rejected}, refused "
                             f"{routed.refused}, raised {routed.raised}")
    if node.processor.metrics.dropped or metrics_total(proc_mod.WORK_EVENTS_DROPPED) != dropped0:
        raise AssertionError(f"{label} dropped {node.processor.metrics.dropped}")
    if cell.to_pub:
        raise AssertionError(f"{label} the node sent pub gossip: {cell.to_pub[:3]}")
    slasher = node.slasher
    if slasher.attester_slashings or slasher.dropped_findings or \
            metrics_total(metrics.SLASHER_SLASHINGS) != slashings0:
        raise AssertionError(f"{label} the slasher found a slashing in honest traffic")
    votes, fc = chain.fork_choice.votes, chain.fork_choice
    idx = np.asarray(voters)
    if not (np.all(votes.next_epoch[idx] == epoch)
            and np.all(votes.next_root_id[idx] == fc.proto.root_id(root))):
        raise AssertionError(f"{label} a sender's vote is not in fork choice")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label} {name} was not launched in the drain")
    if {k: sum(d[k] for _, d in per_dispatch.dispatches) for k in launches} != launches:
        raise AssertionError(f"{label} dispatches {per_dispatch.dispatches} against "
                             f"the phase's launches {launches}")
    committees = len({int(a.data.index) for _, a in signed})
    fabric_name = "the wire" if cell.wire else "the hub"
    log(f"{label} {card}: pub published {len(signed)} unaggregated attestations of slot "
        f"{int(state.slot)} ({committees} committees x {len(signed) // committees} members) "
        f"and {len(aggregates)} aggregates (aggregators {aggregators[:4]}...) over "
        f"{fabric_name} as snappy SSZ on their topics to a LocalNode (max_workers="
        f"{node.processor.max_workers}, slasher on, history {SLASHER_HISTORY} epochs) while its "
        f"workers were held: the attestations published in {att_pub_s:.3f} s, handed to the "
        f"processor in {att_handoff_s:.3f} s, drained in {att_wall:.2f} s from the first "
        f"publish to idle: {len(signed) / att_wall:.1f} attestations/s; the aggregates "
        f"published in {agg_pub_s:.3f} s, handed over in {agg_handoff_s:.3f} s, drained in "
        f"{agg_wall:.2f} s; pub's sends {fabric['deliver']:.3f} s over "
        f"{fabric['deliver_calls']} calls, the node's service receipts "
        f"{fabric['receive']:.3f} s over {fabric['receive_calls']} messages (every one pub "
        f"sent, in order, by topic and message id); every vote and aggregate applied, every "
        f"aggregator observed, each batch one supervised bls_verify batch on the card (verdict "
        f"True), no host fallback, nothing dropped, nothing forwarded to pub, no slashing; Fq "
        f"launches {launches}")
    for b, rec, sp, n_launches in matched:
        st = rec["stages_s"]
        log(f"{label} {b['kind']} batch of {b['items']} items ({b['n']} candidates, "
            f"{b['sets']} sets), bucket {rec['shape']}: queue_wait "
            f"{sp.get('queue_wait', 0.0):.4f} s, preverify {b['preverify_s']:.3f} s, verify "
            f"{b['verify_s']:.3f} s (setup {st['setup']:.3f} s, dispatch {st['dispatch']:.3f} "
            f"s, wait {st['wait']:.3f} s, verdict {st['verdict']:.3f} s), apply "
            f"{b['apply_s']:.3f} s, slasher {b['slasher_s']:.3f} s, the handler "
            f"{b['wall_s']:.3f} s; Fq launches {n_launches}")
    return {"launches": launches, "sizes": sizes, "buckets": [r["shape"] for _, r, _, _ in matched],
            "batches": [(b["kind"], b["items"], b["sets"]) for b, *_ in matched],
            "dispatch_launches": [(b["sets"], d) for b, _, _, d in matched],
            "fabric_s": fabric}


def burst_inputs(label: str, case, chain, count: int, skip: int, nth: int, tampered: int = 0):
    """``count`` attestations of each committee of the head state's slot
    after its first ``skip`` members, the aggregates over them (each
    committee's ``nth`` aggregator) and ``tampered`` more after those;
    with the seconds of the signing."""
    from lighthouse_tpu_torch.consensus import helpers as h

    state, root = chain.head_state, chain.head_root
    committees = h.get_committee_count_per_slot(
        state, h.compute_epoch_at_slot(int(state.slot), case.spec), case.spec)
    t = time.perf_counter()
    points = {}
    signed = committee_attestations(case, state, root, count, skip=skip, points=points)
    extra = committee_attestations(case, state, root, tampered, skip=skip + count,
                                   points=points)[:tampered] if tampered else []
    sign_s = time.perf_counter() - t
    t = time.perf_counter()
    aggregates = committee_aggregates(case, state, signed, points, nth=nth)
    aggregate_sign_s = time.perf_counter() - t
    if len(signed) != count * committees:
        raise AssertionError(f"{label} {len(signed)} attestations for {committees} committees")
    log(f"{label} {len(signed)} attestations ({committees} committees x {count} members after "
        f"the first {skip}) signed on the host in {sign_s:.2f} s; {len(aggregates)} aggregates "
        f"(each committee's aggregator number {nth + 1} in key order) in "
        f"{aggregate_sign_s:.2f} s")
    return signed, aggregates, extra


def phase_wire(card: str, case, chain) -> dict:
    """[wire] on [chain]'s node before [network] and the import (see the
    module docstring).  Returns its burst's numbers; the cell is shut
    down."""
    from lighthouse_tpu_torch import device_pipeline

    if device_pipeline.enabled():
        raise AssertionError("[wire] the device pipeline is on; each batch must be one verify")
    signed, aggregates, _ = burst_inputs("[wire]", case, chain, WIRE_ATTESTERS, skip=0, nth=0)
    t = time.perf_counter()
    cell = NetworkCell(chain, case.spec.slots_per_epoch, wire=True)
    fabric_s = time.perf_counter() - t
    routed = RoutedBatches(cell.node).__enter__()
    try:
        with Patched({}, wire_targets()) as spans:
            out = gossip_burst("[wire]", card, cell, routed, chain, case.spec, signed,
                               aggregates)
    finally:
        routed.__exit__(None, None, None)
        cell.shutdown()
    ws, n = cell.wire_s, len(signed) + len(aggregates)
    steps = ", ".join(f"{k} {v:.4f} s" for k, v in sorted(ws["steps"].items()))
    log(f"[wire] {card}: the fabric in {fabric_s:.2f} s: pub's discv5 lookup (bootstrap from "
        f"the node's ENR: the WHOAREYOU handshake, PING, FINDNODE sweeps; then the node's own "
        f"record at distance 0) {ws['lookup']:.3f} s; its signature verifies, its ip/tcp "
        f"{cell.listen[0]}:{cell.listen[1]} are the node's listener and its key the node's "
        f"Noise identity; the dial {ws['dial']:.3f} s (the ladder: {steps}), the node's side "
        f"connected {ws['connected']:.3f} s later; both Noise-proven identities are the peers' "
        f"ENR keys; the meshes held each other on all {len(cell.subnet_topics) + 1} topics "
        f"after {ws['mesh']:.2f} s")
    log(f"[wire] the wire during the burst ({n} messages), both ends: the native "
        f"ChaCha20-Poly1305 seal {spans.get('seal', 0.0):.3f} s over {spans.get('seal_calls', 0)} "
        f"calls, open {spans.get('open', 0.0):.3f} s over {spans.get('open_calls', 0)} calls; "
        f"yamux frame sends (each with its seal and socket write) "
        f"{spans.get('yamux_send', 0.0):.3f} s over {spans.get('yamux_send_calls', 0)}, frame "
        f"receipts {spans.get('yamux_receive', 0.0):.3f} s over "
        f"{spans.get('yamux_receive_calls', 0)}; meshsub framing: encode "
        f"{spans.get('meshsub_encode', 0.0):.3f} s over {spans.get('meshsub_encode_calls', 0)} "
        f"calls, decode {spans.get('meshsub_decode', 0.0):.3f} s over "
        f"{spans.get('meshsub_decode_calls', 0)} calls; pub's sends "
        f"{out['fabric_s']['deliver']:.3f} s, the node's service receipts "
        f"{out['fabric_s']['receive']:.3f} s")
    return out


def phase_network(card: str, case, chain) -> dict:
    """[network] on [chain]'s node before its import, after [wire] (see
    the module docstring).  Returns its numbers, and under ``"cell"`` the
    live :class:`NetworkCell` and under ``"routed"`` its recorder, which
    :func:`network_double_vote` goes on with and [chain] shuts down."""
    from lighthouse_tpu_torch import device_pipeline
    from lighthouse_tpu_torch.scheduler import W

    if device_pipeline.enabled():
        raise AssertionError("[network] the device pipeline is on; each batch must be one verify")
    state, spec = chain.head_state, case.spec
    signed, aggregates, extra = burst_inputs("[network]", case, chain, NET_ATTESTERS,
                                             skip=WIRE_ATTESTERS, nth=1, tampered=NET_TAMPERED)
    tampered = [a for _, a in extra]
    tampered[3].signature = bytes(tampered[4].signature)
    cell = NetworkCell(chain, spec.slots_per_epoch)
    node = cell.node
    routed = RoutedBatches(node).__enter__()
    try:
        out = gossip_burst("[network]", card, cell, routed, chain, spec, signed, aggregates)

        # A tampered batch: 8 more attestations, one under another key.
        first = len(routed.batches)
        mark = runtime_mark()
        with DispatchLaunches() as tamper_dispatch:
            with HeldWorkers(node.processor):
                cell.publish([(cell.attestation_topic(state, a, spec), a.as_ssz_bytes())
                              for a in tampered], W.GOSSIP_ATTESTATION, "[network] tampered")
            t = time.perf_counter()
            if not node.wait_idle(NET_IDLE_S):
                raise AssertionError("[network] the node did not drain the tampered batch")
            tampered_s = time.perf_counter() - t
        late = routed.batches[first:]
        rec = [r["verdict"] for r in assert_on_device("[network] tampered", mark)
               if r["op"] == "bls_verify"]
        bad = extra[3][0]
        if [(b["n"], b["verdict"]) for b in late] != [(NET_TAMPERED, False)] or \
                rec != [False] + [i != 3 for i in range(NET_TAMPERED)] or \
                routed.refused != [bad] or routed.rejected != [("pub", "bad_signature")] or \
                routed.applied[len(signed):] != [v for v, _ in extra if v != bad]:
            raise AssertionError(f"[network] the tampered batch: batches "
                                 f"{[(b['n'], b['verdict']) for b in late]}, records {rec}, "
                                 f"refused {routed.refused}, rejected {routed.rejected}")
        score = node.service.peer_manager.score("pub")
        if not score < 0 or cell.to_pub or node.processor.metrics.dropped:
            raise AssertionError(f"[network] after the tampered batch: pub's score {score}, "
                                 f"sent to pub {cell.to_pub[:3]}")
        log(f"[network] {NET_TAMPERED} more, one carrying another member's signature, "
            f"published while the workers were held: one batch, False on the card, then "
            f"{NET_TAMPERED} single verifies on the card; exactly one bad_signature rejection "
            f"(pub's score {score:.2f}), {NET_TAMPERED - 1} applied, in {tampered_s:.2f} s; "
            f"dispatches {[n for n, _ in tamper_dispatch.dispatches]}")
    except BaseException:
        routed.__exit__(None, None, None)
        cell.shutdown()
        raise
    out.update({"cell": cell, "routed": routed})
    return out


def network_double_vote(card: str, case, chain, clock, net: dict) -> None:
    """After [chain]'s import: a validator of slot S+1 that holds a real key
    in the case (a sync-committee member or another validator the case
    signs for, not slashed) publishes two attestations of
    slot S+1 with one target, one voting for the imported block as head and
    one for the anchor, each after the node went idle.  The first is
    applied; the second takes the router's slasher-only path; the slasher
    finds the one double vote, the router verifies the ``AttesterSlashing``
    on the card, pools it and publishes it to pub.  Its bytes are those of
    the port's slasher on the CPU fed the same two indexed attestations."""
    import resource

    from lighthouse_tpu_torch import metrics
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.ops import cuda_fq
    from lighthouse_tpu_torch.scheduler import W
    from lighthouse_tpu_torch.slasher import Slasher, SlasherConfig
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_ATTESTER
    from lighthouse_tpu_torch.workload import _Signer

    cell, routed = net["cell"], net["routed"]
    node, types, spec, sk = cell.node, case.types, case.spec, case.keys.secret
    state, head = chain.head_state, chain.head_root
    slot = int(state.slot) + 1
    epoch = h.compute_epoch_at_slot(slot, spec)
    voter = None
    for c in range(h.get_committee_count_per_slot(state, epoch, spec)):
        committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
        keyed = [v for v in committee if v in sk and not state.validators[v].slashed]
        if keyed:
            voter, index, position, size = keyed[0], c, committee.index(keyed[0]), len(committee)
            break
    if voter is None:
        raise AssertionError(f"[network] no member of slot {slot}'s committees holds a key")
    clock.set_slot(slot + 1)
    anchor = chain.genesis_block_root
    target = types.Checkpoint(epoch=epoch, root=h.get_block_root(state, epoch, spec))
    domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, epoch, spec)
    signer, votes = _Signer(), []
    for vote_head in (head, anchor):
        data = types.AttestationData(slot=slot, index=index, beacon_block_root=vote_head,
                                     source=state.current_justified_checkpoint.copy(),
                                     target=target.copy())
        bits = [False] * size
        bits[position] = True
        votes.append(types.Attestation(
            aggregation_bits=bits, data=data,
            signature=signer.sign(h.compute_signing_root(data.hash_tree_root(), domain),
                                  sk[voter])))
    expected = Slasher(types, SlasherConfig(history_length=SLASHER_HISTORY,
                                            slots_per_epoch=spec.slots_per_epoch))
    for att in votes:
        expected.on_attestation(h.get_indexed_attestation(state, att, types, spec))
    (want,), _ = expected.drain_slashings()
    pooled0 = metrics.SLASHER_SLASHINGS.get(kind="attester_slashing", outcome="pooled")
    others0 = metrics_total(metrics.SLASHER_SLASHINGS) - pooled0
    first, applied0, received0 = len(routed.batches), len(routed.applied), len(cell.received)
    pool0 = dict(chain.op_pool._attester_slashings)
    mark = runtime_mark()
    cuda_fq.reset_launch_counts()
    t = time.perf_counter()
    seconds = []
    for att in votes:
        t1 = time.perf_counter()
        cell.publish([(cell.attestation_topic(state, att, spec), att.as_ssz_bytes())],
                     W.GOSSIP_ATTESTATION, "[network] double vote")
        if not node.wait_idle(NET_IDLE_S):
            raise AssertionError("[network] the node did not drain a double vote")
        seconds.append(time.perf_counter() - t1)
    wait_for("[network] the slashing at pub", lambda: len(cell.received) > received0, 60.0)
    wall = time.perf_counter() - t
    launches = dict(cuda_fq.LAUNCHES)
    records = [r for r in assert_on_device("[network] double vote", mark)
               if r["op"] == "bls_verify"]
    late = routed.batches[first:]
    pooled = [s for k, s in chain.op_pool._attester_slashings.items() if k not in pool0]
    got = cell.received[received0:]
    slashed = set(pooled[0].attestation_1.attesting_indices) & set(
        pooled[0].attestation_2.attesting_indices) if pooled else set()
    if [(b["n"], b["verdict"]) for b in late] != [(1, True), (1, True)] or \
            routed.applied[applied0:] != [voter] or \
            [(r["n_live"], r["verdict"]) for r in records] != [(1, True), (1, True), (2, True)]:
        raise AssertionError(f"[network] the double vote's batches "
                             f"{[(b['n'], b['verdict']) for b in late]}, applied "
                             f"{routed.applied[applied0:]}, records "
                             f"{[(r['n_live'], r['verdict']) for r in records]}")
    if metrics.SLASHER_SLASHINGS.get(kind="attester_slashing", outcome="pooled") != pooled0 + 1 \
            or metrics_total(metrics.SLASHER_SLASHINGS) - pooled0 - 1 != others0 or \
            len(pooled) != 1 or slashed != {voter}:
        raise AssertionError(f"[network] the slasher: pooled {len(pooled)} slashings of "
                             f"{sorted(slashed)}, expected one of {voter}")
    if pooled[0].as_ssz_bytes() != want.as_ssz_bytes() or \
            [(tp, raw) for tp, raw, _ in got] != [(cell.slashing_topic, want.as_ssz_bytes())] or \
            cell.to_pub != [cell.slashing_topic]:
        raise AssertionError(f"[network] the slashing's bytes or its publication: pub received "
                             f"{[tp for tp, _, _ in got]}, the node sent {cell.to_pub}")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[network] {name} was not launched for the double vote")
    db = node.slasher.db
    array_bytes = db._sources.nbytes + db._targets.nbytes + db._roots.nbytes
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    slasher_s = sum(b["slasher_s"] for b in routed.batches)
    log(f"[network] {card}: validator {voter} (committee {index} of slot {slot}) voted twice for "
        f"target epoch {epoch}, head the block then the anchor: the first applied, the second "
        f"verified on the card and fed to the slasher only ({seconds[0]:.2f} s, {seconds[1]:.2f} "
        f"s); the slasher found one double vote of {voter}, on_gossip_attester_slashing "
        f"verified it on the card (2 sets), slasher_slashings_total{{outcome=pooled}} +1, the "
        f"op pool holds it and pub received it on the attester-slashing topic, its bytes those "
        f"of the CPU path, in {wall:.2f} s in all; Fq launches {launches}; batches "
        f"{[(b['n'], round(b['slasher_s'], 3)) for b in late]} (candidates, slasher s)")
    log(f"[network] the slasher over the whole phase: {slasher_s:.2f} s in its calls; its "
        f"arrays {db._sources.shape[0]} validators x {SLASHER_HISTORY} epochs, {array_bytes} "
        f"bytes ({array_bytes / 2**30:.2f} GiB); the process's peak RSS {rss} bytes "
        f"({rss / 2**30:.2f} GiB)")


def metrics_total(counter) -> float:
    """The sum of a counter over its label sets."""
    return sum(counter.snapshot().values())


def phase_chain(card: str, case, anchor, kzg_in, device: str = "cuda") -> dict:
    """A checkpoint-synced node at mainnet width on the default device (see
    the module docstring).  ``anchor`` is a copy of the case's pre-state
    taken before [block] applied the block to it, with [block]'s warm
    tree-hash cache; the kernels' launch counts are set to 0 just before
    the import and read just after it."""
    import copy
    import shutil
    import sys
    import tempfile

    from lighthouse_tpu_torch import tracing
    from lighthouse_tpu_torch.chain import BeaconChain, BlockError, ManualSlotClock
    from lighthouse_tpu_torch.chain import beacon_chain as bc_mod
    from lighthouse_tpu_torch.consensus import per_block
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.execution_layer import ExecutionLayer
    from lighthouse_tpu_torch.execution_layer.engine_api import kzg_commitment_to_versioned_hash
    from lighthouse_tpu_torch.execution_layer.mock_server import MockEngineServer
    from lighthouse_tpu_torch.ops import cuda_fq, cuda_sha
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.store import DBColumn, HotColdDB, LockboxStore
    from lighthouse_tpu_torch.workload import blob_sidecars, resign

    st_mod = sys.modules["lighthouse_tpu_torch.consensus.state_transition"]
    kzg, blobs, _commitments, proofs = kzg_in
    signed, types, spec = case.signed_block, case.types, case.spec
    block = signed.message
    slot = int(block.slot)
    block_root = block.hash_tree_root()
    state_cls = type(anchor)
    t = time.perf_counter()
    sidecars = blob_sidecars(case, blobs, proofs)
    sidecars_s = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    path = str(Path(tmp) / "chain.db")
    net = None
    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=True, device=device)
    store = None
    # The node's execution engine: the Engine API over HTTP with JWT, to
    # the mock engine; every JSON-RPC call it answers is kept.
    server = MockEngineServer(EL_JWT_SECRET)
    engine_calls = []
    answer = server.handle

    def handle(method, params):
        engine_calls.append((method, params))
        return answer(method, params)

    server.handle = handle
    server.start()
    try:
        # The anchor: its root from the cache it carries, then the node.
        t = time.perf_counter()
        anchor.hash_tree_root()
        warm_root_s = time.perf_counter() - t
        store = LockboxStore(path)
        clock = ManualSlotClock(int(anchor.genesis_time), spec.seconds_per_slot)
        clock.set_slot(slot)
        with Patched({}, [(bc_mod, "genesis_block_root_of", "root"),
                          (state_cls, "as_ssz_bytes", "ssz"),
                          (store, "do_atomically", "lockbox_put"),
                          (bc_mod, "ForkChoice", "fork_choice")]) as anchor_s:
            t = time.perf_counter()
            el = ExecutionLayer(url=server.url, jwt_secret=EL_JWT_SECRET)
            chain = BeaconChain(genesis_state=anchor, types=types, spec=spec,
                                db=HotColdDB(hot=store), slot_clock=clock,
                                execution_engine=el, kzg=kzg)
            anchor_s["wall"] = time.perf_counter() - t
        if chain.genesis_block_root != bytes(block.parent_root):
            raise AssertionError("[chain] the anchor's block root is not the block's parent")
        log(f"[chain] {card}: the anchor (the case's pre-state, {len(anchor.validators)} "
            f"validators at slot {int(anchor.slot)}): its root from the tree-hash cache its "
            f"copy carries from [block] in {warm_root_s:.2f} s, then "
            f"BeaconChain(db=HotColdDB(hot=LockboxStore)) in "
            f"{anchor_s['wall']:.2f} s: its root {anchor_s['root']:.3f} s, its store write "
            f"{anchor_s['ssz'] + anchor_s['lockbox_put']:.2f} s (SSZ bytes "
            f"{anchor_s['ssz']:.2f} s, "
            f"the lockbox put {anchor_s['lockbox_put']:.2f} s), the fork-choice anchor "
            f"{anchor_s['fork_choice']:.2f} s; {len(sidecars)} sidecars built in "
            f"{sidecars_s:.2f} s")

        # The DA gate's header rule, on the card: the sidecars' header
        # carries the block's signature (its root is the block's root).
        mark = runtime_mark()
        t = time.perf_counter()
        if not chain.verify_block_header_signature(sidecars[0].signed_block_header):
            raise AssertionError("[chain] the sidecars' header signature was refused")
        forged = copy.deepcopy(sidecars[0].signed_block_header)
        forged.signature = bytes(signed.message.body.randao_reveal)
        if chain.verify_block_header_signature(forged):
            raise AssertionError("[chain] a header with another signature was accepted")
        header_s = time.perf_counter() - t
        headers = [r for r in assert_on_device("[chain] header", mark) if r["op"] == "bls_verify"]
        if [r["verdict"] for r in headers] != [True, False]:
            raise AssertionError(f"[chain] the header checks' records {headers}")

        # [wire], then [network]: slot S-1's gossip reaches the node before
        # block S does, as on mainnet; first over a socket from a peer found
        # through discv5, then over the hub.
        with phase_wall("wire"):
            wire = phase_wire(card, case, chain)
        with phase_wall("network"):
            net = phase_network(card, case, chain)

        # The import.
        verifier = per_block.BlockSignatureVerifier
        targets = [(st_mod, "process_slots", "process_slots"),
                   (st_mod, "per_block_processing", "per_block"),
                   (verifier, "include_all_signatures", "collect"),
                   (verifier, "verify", "verify"),
                   (state_cls, "copy", "copy"),
                   (state_cls, "as_ssz_bytes", "ssz"),
                   (store, "do_atomically", "lockbox_put"),
                   (chain.db, "migrate", "migrate"),
                   (el, "notify_new_payload", "new_payload")]
        mark = runtime_mark()
        calls_before = len(engine_calls)
        with Patched({}, targets) as spans:
            cuda_fq.reset_launch_counts()
            cuda_sha.reset_launch_counts()
            t = time.perf_counter()
            root = chain.process_block_with_blobs(signed, sidecars)
            wall = time.perf_counter() - t
            launches = {**dict(cuda_fq.LAUNCHES), **dict(cuda_sha.LAUNCHES)}
        import_calls = engine_calls[calls_before:]
        records = assert_on_device("[chain]", mark)
        by_op = {}
        for r in records:
            by_op.setdefault(r["op"], []).append(r)
        verifies, kzgs = by_op.get("bls_verify", []), by_op.get("kzg_batch", [])
        # The block's sets: its attestations, and the proposal, the RANDAO
        # reveal, two per slashing, the exit, the change, the sync aggregate.
        if len(verifies) != 1 or verifies[0]["verdict"] is not True or \
                verifies[0]["n_live"] != len(block.body.attestations) + 9:
            raise AssertionError(f"[chain] the import's bls_verify records {verifies}")
        if len(kzgs) != 1 or kzgs[0]["verdict"] is not True:
            raise AssertionError(f"[chain] the import's kzg_batch records {kzgs}")
        for name in ("fq_mul", "fq2_mul", "sha256_pairs", "tree_hash_subtrees"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{name} was not launched during the chain's import")
        new_payloads = [p for m, p in import_calls if m.startswith("engine_newPayload")]
        fcus = [m for m, _ in import_calls if m.startswith("engine_forkchoiceUpdated")]
        hashes = ["0x" + kzg_commitment_to_versioned_hash(c).hex()
                  for c in block.body.blob_kzg_commitments]
        if [m for m, _ in import_calls if m.startswith("engine_newPayload")] != \
                ["engine_newPayloadV3"] or new_payloads[0][1] != hashes or \
                new_payloads[0][2] != "0x" + bytes(block.parent_root).hex() or \
                new_payloads[0][0]["blockHash"] != \
                "0x" + bytes(block.body.execution_payload.block_hash).hex():
            raise AssertionError(f"[chain] the import's Engine API calls "
                                 f"{[m for m, _ in import_calls]}")
        if not fcus:
            raise AssertionError("[chain] no forkchoiceUpdated after the import")
        trace = tracing.TRACES.recent(limit=1, root="block_import")[0]
        sp = span_seconds(trace)
        for name in ("block_import", "da_check", "state_transition", "fork_choice",
                     "store_write", "head_recompute"):
            if name not in sp:
                raise AssertionError(f"[chain] the import's trace has no {name} span: {sorted(sp)}")
        vst, kst = verifies[0]["stages_s"], kzgs[0]["stages_s"]
        stages = {
            "da_check": sp["da_check"], "da_device": kst["dispatch"] + kst["wait"],
            "copy": spans["copy"], "process_slots": spans["process_slots"],
            "collect": spans["collect"], "verify_setup": vst["setup"],
            "verify_device": vst["dispatch"] + vst["wait"], "verify": spans["verify"],
            "operations": spans["per_block"] - spans["collect"] - spans["verify"],
            "root": sp["state_transition"] - spans["process_slots"] - spans["per_block"],
            "state_transition": sp["state_transition"], "fork_choice": sp["fork_choice"],
            "store_write": sp["store_write"], "ssz": spans.get("ssz", 0.0),
            "lockbox_put": spans.get("lockbox_put", 0.0),
            "head_recompute": sp["head_recompute"], "migrate": spans.get("migrate", 0.0),
            "block_import": sp["block_import"]}
        stages["other"] = stages["block_import"] - sum(
            stages[k] for k in ("da_check", "copy", "state_transition", "fork_choice",
                                "store_write", "head_recompute"))
        log(f"[chain] {card}: process_block_with_blobs imported the block and its "
            f"{len(sidecars)} sidecars in {wall:.3f} s (span block_import "
            f"{stages['block_import']:.3f} s): da_check {stages['da_check']:.3f} s (the 6-blob "
            f"kzg_batch's device stage {stages['da_device']:.3f} s), parent_state.copy() "
            f"{stages['copy']:.3f} s, state_transition {stages['state_transition']:.3f} s "
            f"(process_slots {stages['process_slots']:.3f} s, signature-set collection "
            f"{stages['collect']:.3f} s, the verify {stages['verify']:.3f} s: setup "
            f"{stages['verify_setup']:.3f} s, device {stages['verify_device']:.3f} s; operations "
            f"{stages['operations']:.3f} s, the post-block root {stages['root']:.3f} s), "
            f"fork_choice {stages['fork_choice']:.3f} s, store_write {stages['store_write']:.3f} s "
            f"(SSZ bytes {stages['ssz']:.3f} s, the lockbox put {stages['lockbox_put']:.3f} s), "
            f"head_recompute {stages['head_recompute']:.3f} s (the hot->cold migration "
            f"{stages['migrate']:.3f} s), the rest {stages['other']:.3f} s")
        log(f"[chain] the Engine API over HTTP with JWT: the import sent "
            f"{[m for m, _ in import_calls]} to the mock engine; engine_newPayloadV3 carried the "
            f"{len(hashes)} versioned hashes of the sidecars' commitments and the parent root; "
            f"notify_new_payload (a {len(block.body.execution_payload.transactions)}-transaction "
            f"payload as JSON over HTTP, VALID) {spans['new_payload']:.3f} s")
        log(f"[chain] one supervised kzg_batch ({kzgs[0]['shape']}, {kzgs[0]['n_live']} live) and "
            f"one supervised bls_verify batch ({verifies[0]['shape']}, {verifies[0]['n_live']} "
            f"sets) on the card, no host fallback, breakers closed; kernel launches {launches}; "
            f"the sidecars' header signature checked on the card in {header_s:.2f} s (True; "
            f"another signature False)")

        # The node's view after the import.
        post = chain.get_state(root)
        ref = case.host_state
        if root != block_root or chain.head_root != block_root:
            raise AssertionError("[chain] the head is not the block")
        if post.hash_tree_root() != ref.hash_tree_root():
            raise AssertionError("[chain] the post-state's root != the host run's")
        if list(post.balances) != list(ref.balances):
            raise AssertionError("[chain] balances != the host run's")
        for field in ("previous_epoch_participation", "current_epoch_participation"):
            if list(getattr(post, field)) != list(getattr(ref, field)):
                raise AssertionError(f"[chain] {field} != the host run's")
        # The post-state's own SSZ bytes come from [http]'s checkpoint-sync
        # download, compared there with these.
        t = time.perf_counter()
        ref_ssz = ref.as_ssz_bytes()
        ref_ssz_s = time.perf_counter() - t
        got = chain.get_blobs(root)
        if [sc.as_ssz_bytes() for sc in got] != [sc.as_ssz_bytes() for sc in sidecars]:
            raise AssertionError("[chain] get_blobs does not return the six sidecars")
        log(f"[chain] the head is the block; its post-state equals the host run's (root, "
            f"balances, participation; its SSZ bytes in [http] against the host run's "
            f"{len(ref_ssz)}, encoded in {ref_ssz_s:.2f} s); get_blobs returns the {len(got)} "
            f"sidecars")

        # The sync batch: the committee signs the new head at the block's slot.
        t = time.perf_counter()
        msgs = sync_messages(case, chain, root, slot)
        sign_s = time.perf_counter() - t
        mark = runtime_mark()
        cuda_fq.reset_launch_counts()
        t = time.perf_counter()
        results = chain.process_sync_committee_messages(msgs)
        sync_s = time.perf_counter() - t
        sync_launches = dict(cuda_fq.LAUNCHES)
        if results != [None] * len(msgs):
            raise AssertionError(f"[chain] the sync batch's results {set(results)}")
        sync_rec = [r for r in assert_on_device("[chain] sync", mark) if r["op"] == "bls_verify"]
        if len(sync_rec) != 1 or sync_rec[0]["verdict"] is not True or \
                sync_rec[0]["n_live"] != len(msgs):
            raise AssertionError(f"[chain] the sync batch's records {sync_rec}")
        sst = sync_rec[0]["stages_s"]
        tampered = [m.copy() for m in msgs[:CHAIN_SYNC_TAMPERED]]
        tampered[3].signature = bytes(msgs[4].signature)
        mark = runtime_mark()
        t = time.perf_counter()
        results = chain.process_sync_committee_messages(tampered)
        tampered_s = time.perf_counter() - t
        bad = [i for i, r in enumerate(results) if r is not None]
        if bad != [3]:
            raise AssertionError(f"[chain] the tampered sync batch's results {results}")
        t_rec = [r for r in assert_on_device("[chain] sync tampered", mark)
                 if r["op"] == "bls_verify"]
        if [r["verdict"] for r in t_rec] != [False] + [i != 3 for i in range(CHAIN_SYNC_TAMPERED)]:
            raise AssertionError(f"[chain] the tampered sync batch's records "
                                 f"{[(r['shape'], r['verdict']) for r in t_rec]}")
        log(f"[chain] {card}: {len(msgs)} sync-committee messages over the head signed on the "
            f"host in {sign_s:.2f} s; process_sync_committee_messages: all None in {sync_s:.3f} s "
            f"from one supervised bls_verify batch on the card ({sync_rec[0]['shape']}, "
            f"{sync_rec[0]['n_live']} sets; setup {sst['setup']:.3f} s, device "
            f"{sst['dispatch'] + sst['wait']:.3f} s, verdict {sst['verdict']:.3f} s; launches "
            f"{sync_launches}); {CHAIN_SYNC_TAMPERED} messages with one carrying another "
            f"member's signature: exactly one error in {tampered_s:.2f} s (the batch False on "
            f"the card, then {len(t_rec) - 1} single verifies on the card)")

        # The refusals: each raises BlockError and leaves the node as it was.
        refusals = {}
        before = chain_snapshot(chain)
        message = copy.deepcopy(block)
        message.body.graffiti = b"refused: sidecar 3 has 4's proof".ljust(32, b"\x00")
        other = case._replace(signed_block=resign(case, message))
        bad_proofs = list(proofs)
        bad_proofs[3] = proofs[4]
        mark = runtime_mark()
        t = time.perf_counter()
        try:
            chain.process_block_with_blobs(other.signed_block,
                                           blob_sidecars(other, blobs, bad_proofs))
        except BlockError as err:
            if "blob KZG batch verification failed" not in str(err):
                raise
        else:
            raise AssertionError("[chain] a sidecar with another blob's proof was accepted")
        refusals["da_s"] = time.perf_counter() - t
        rec = [r for r in assert_on_device("[chain] refused DA", mark) if r["op"] == "kzg_batch"]
        if [r["verdict"] for r in rec] != [False]:
            raise AssertionError(f"[chain] the refused DA batch's records {rec}")
        if chain_snapshot(chain) != before:
            raise AssertionError("[chain] the refused DA import changed the node")
        log(f"[chain] refused on {card}, the head, the store's {before['keys']} keys and the "
            f"block caches unchanged: a copy of the block whose sidecar 3 carries sidecar 4's "
            f"proof (BlockError, the kzg_batch False on the card) in {refusals['da_s']:.2f} s "
            f"(the block with two attestation signatures swapped is refused in "
            f"[chain-harness])")

        # [network]'s double vote, on the node after the import.
        with phase_wall("network-double-vote"):
            network_double_vote(card, case, chain, clock, net)
        net["cell"].shutdown()

        # [http]: the Beacon API on the node; its checkpoint-sync download
        # is the post-state's SSZ for the restart below.  Then [vc]: a
        # validator client with keystore-imported keys on the same server.
        served = api_server(chain)
        try:
            with phase_wall("http"):
                http_out = phase_http(card, case, chain, sidecars, ref_ssz, device=device,
                                      served=served)
            post_ssz = http_out.pop("state_ssz")
            del ref_ssz
            # [client]: the node an operator starts on the post-state, in a
            # second process, its gates run beside [vc].
            slashings = chain.op_pool.attester_slashings()
            if len(slashings) != 1:
                raise AssertionError(f"[client] [chain]'s pool holds {len(slashings)} "
                                     f"attester slashings, not the double vote's one")
            client = ClientCell(card, chain, served, post_ssz, slashings[0], case.spec,
                                device=device)
            try:
                with phase_wall("vc"):
                    vc_out = phase_vc(card, case, chain, clock, served, tmp)
            except BaseException:
                client.abort()
                raise
            client_out = client.finish()
            log(f"[phase] client {client_out['wall_s']:.1f} s")
        finally:
            served[0].stop()
            served[1].shutdown()

        # The restart: a fresh HotColdDB on the same file.
        state_root = bytes(block.state_root)
        t = time.perf_counter()
        store.close()
        store = LockboxStore(path)
        db = HotColdDB(hot=store, types=types, spec=spec)
        stored = db.get_block(root)
        raw = store.get(DBColumn.BEACON_STATE, state_root)
        summary = db.get_state_summary(state_root)
        restart_s = time.perf_counter() - t
        if stored is None or stored.as_ssz_bytes() != signed.as_ssz_bytes():
            raise AssertionError("[chain] the block read back != the imported block")
        if raw != type(post).fork_name.encode() + b"\x00" + post_ssz:
            raise AssertionError("[chain] the stored state's bytes != the post-state's SSZ")
        if summary is None or summary.latest_block_root != root or summary.slot != slot:
            raise AssertionError(f"[chain] the head state's summary {summary}")
        log(f"[chain] restart: a fresh HotColdDB on the same lockbox file read back the block "
            f"(byte for byte), the post-state's stored value ({len(raw)} bytes, equal to its "
            f"SSZ) and its summary (slot {summary.slot}, the block's root) in {restart_s:.2f} s")
    finally:
        if net is not None:
            net["routed"].__exit__(None, None, None)
            net["cell"].shutdown()
        server.stop()
        if store is not None:
            store.close()
        shutil.rmtree(tmp, ignore_errors=True)
        th.configure(enabled=False)
        torch_backend.reset_for_tests()
    net = {k: v for k, v in net.items() if k not in ("cell", "routed")}
    return {"wire": wire, "network": net, "new_payload_s": spans["new_payload"],
            "engine_calls": [m for m, _ in engine_calls],
            "anchor_s": {"warm_root": warm_root_s, **{k: anchor_s[k] for k in (
                "wall", "root", "ssz", "lockbox_put", "fork_choice")}},
            "wall_s": wall, "stages_s": stages, "launches": launches,
            "kzg_bucket": kzgs[0]["shape"], "verify_bucket": verifies[0]["shape"],
            "sets": verifies[0]["n_live"], "sync_s": sync_s, "sync_sign_s": sign_s,
            "sync_stages_s": sst, "sync_bucket": sync_rec[0]["shape"],
            "sync_tampered_s": tampered_s, "refusals_s": refusals, "restart_s": restart_s,
            "http": http_out, "vc": vc_out, "client": client_out}


def head_attestations(case, state, root: bytes, count: int) -> list:
    """Unaggregated attestations of ``state``'s slot (the head's) for the
    head ``root``: in turn from each committee of the slot, the next member
    the case holds a key for (not slashed), one vote each, until ``count``
    (at mainnet width ``count`` committees give one each).  The target is
    the epoch's first block, the source the state's justified checkpoint.
    Returns (validator, committee, attestation) triples."""
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_ATTESTER
    from lighthouse_tpu_torch.workload import _Signer

    types, spec, sk = case.types, case.spec, case.keys.secret
    slot = int(state.slot)
    epoch = h.compute_epoch_at_slot(slot, spec)
    target = types.Checkpoint(epoch=epoch, root=h.get_block_root(state, epoch, spec))
    domain = h.get_domain(state, DOMAIN_BEACON_ATTESTER, epoch, spec)
    keyed = []
    for c in range(h.get_committee_count_per_slot(state, epoch, spec)):
        committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
        members = [v for v in committee if v in sk and not state.validators[v].slashed]
        if members:
            keyed.append((c, committee, members))
    signer, out = _Signer(), []
    for turn in range(count):
        for c, committee, members in keyed:
            if len(out) == count or turn >= len(members):
                continue
            v = members[turn]
            data = types.AttestationData(slot=slot, index=c, beacon_block_root=root,
                                         source=state.current_justified_checkpoint.copy(),
                                         target=target.copy())
            bits = [False] * len(committee)
            bits[committee.index(v)] = True
            sig = signer.sign(h.compute_signing_root(data.hash_tree_root(), domain), sk[v])
            out.append((v, c, types.Attestation(aggregation_bits=bits, data=data,
                                                signature=sig)))
    if len(out) != count:
        raise AssertionError(f"[http] {len(out)} keyed members in slot {slot}'s committees")
    return out


def http_fetch(port: int, method: str, path: str, body=None, ssz: bool = False,
               timeout: float = HTTP_TIMEOUT_S) -> tuple:
    """One request over a fresh socket: (status, content type, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    headers = {"Accept": "application/octet-stream" if ssz else "application/json"}
    payload = None
    if body is not None:
        payload = json.dumps(body)
        headers["Content-Type"] = "application/json"
    try:
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), resp.read()
    finally:
        conn.close()


def api_server(chain) -> tuple:
    """[http]'s and [vc]'s server on ``chain``: an ``HttpApiServer`` over a
    ``BeaconProcessor`` of two workers, the response cache on, its task
    spawner waiting HTTP_TIMEOUT_S for a handler; with the list its
    ``publish_attestation_fn`` appends to.  Returns (server, processor,
    published), the server started."""
    from lighthouse_tpu_torch.http_api import HttpApiServer
    from lighthouse_tpu_torch.scheduler import BeaconProcessor

    published = []
    processor = BeaconProcessor(max_workers=2)
    server = HttpApiServer(chain, processor=processor, publish_attestation_fn=published.append)
    server.spawner.timeout = HTTP_TIMEOUT_S
    return server.start(), processor, published


def phase_http(card: str, case, chain, sidecars, ref_ssz: bytes, served,
               device: str = "cuda") -> dict:
    """The Beacon API on [chain]'s node (see the module docstring): reads
    checked against the node's own objects, the response cache, three
    attestations POSTed to the pool and verified on the card while the
    profiler runs, and the checkpoint-sync state download (its body,
    equal to ``ref_ssz``, is returned for the restart's comparison).  With
    ``device="cpu"`` (a rehearsal on the plain versions, which launch no
    kernel) the profile's trace need not name ``fq_mul_kernel``.
    ``served`` is :func:`api_server`'s triple, which the caller stops."""
    from lighthouse_tpu_torch import device_pipeline, metrics
    from lighthouse_tpu_torch.chain.rewards import attestation_rewards
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient, container_from_json, to_json
    from lighthouse_tpu_torch.http_api import server as server_mod
    from lighthouse_tpu_torch.ops import cuda_fq

    spec = case.spec
    state, root = chain.head_state, chain.head_root
    signed = chain.get_block(root)
    slot = int(state.slot)
    epoch = h.compute_epoch_at_slot(slot, spec)
    start = h.compute_start_slot_at_epoch(epoch, spec)
    count = h.get_committee_count_per_slot(state, epoch, spec)
    n = len(state.validators)
    rng = random.Random(HTTP_SEED)
    t = time.perf_counter()
    atts = head_attestations(case, state, root, HTTP_ATTESTERS)
    sign_s = time.perf_counter() - t
    bad = atts[-1][2].copy()
    bad.signature = bytes(atts[-2][2].signature)
    posted = [a for _, _, a in atts[:-1]] + [bad]

    server, processor, published = served
    client = BeaconNodeHttpClient(server.url, timeout=HTTP_TIMEOUT_S)
    cache = server.response_cache
    seconds = []  # (label, client s, server s)
    first_cached = []  # labels of the first asks of cached routes

    def timed(label, method, path, fn):
        """``fn()`` (one request), with its client seconds and the server's
        ``http_api_request_seconds`` for its route template."""
        _, handler, _, route = server_mod.match_route(method, path.split("?")[0])
        if hasattr(handler, "_cache_topics") and not label.endswith("(again)"):
            first_cached.append(label)
        n0, s0 = metrics.HTTP_REQUEST_SECONDS.stats(method=method, route=route)
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        deadline = time.time() + 5
        while metrics.HTTP_REQUEST_SECONDS.stats(method=method, route=route)[0] == n0 \
                and time.time() < deadline:
            time.sleep(0.005)
        n1, s1 = metrics.HTTP_REQUEST_SECONDS.stats(method=method, route=route)
        if n1 != n0 + 1:
            raise AssertionError(f"[http] {label}: http_api_request_seconds counted {n1 - n0}")
        seconds.append((label, wall, s1 - s0))
        return out

    def get(label, path):
        return timed(label, "GET", path, lambda: client.get(path))

    def fetch(label, method, path, body=None, ssz=False):
        out = timed(label, method, path,
                    lambda: http_fetch(server.port, method, path, body, ssz))
        if out[0] not in (200, 206):
            raise AssertionError(f"[http] {label}: HTTP {out[0]} {out[2][:300]!r}")
        return out

    def cached_twice(label, method, path, body=None):
        """Ask twice: the second answer a hit, byte for byte the first, no
        handler run (the processor received nothing)."""
        route = server_mod.match_route(method, path.split("?")[0])[3]
        first = fetch(label, method, path, body)
        hits0 = metrics.HTTP_CACHE_HITS.get(route=route)
        misses0, received0 = cache.misses, sum(processor.metrics.received.values())
        second = fetch(label + " (again)", method, path, body)
        if second[2] != first[2] or metrics.HTTP_CACHE_HITS.get(route=route) != hits0 + 1 or \
                cache.misses != misses0 or \
                sum(processor.metrics.received.values()) != received0:
            raise AssertionError(f"[http] {label}: the second answer was not a cache hit")
        return json.loads(first[2])

    grants0 = device_pipeline.ARBITER.snapshot()["grants"].get("http_api", 0)
    # Reads, each against the node's own objects.
    if timed("node/version", "GET", "/eth/v1/node/version", client.node_version) != \
            server_mod.VERSION_STRING:
        raise AssertionError("[http] node/version")
    syncing = get("node/syncing", "/eth/v1/node/syncing")["data"]
    distance = chain.current_slot() - slot
    if syncing["head_slot"] != str(slot) or syncing["sync_distance"] != str(distance):
        raise AssertionError(f"[http] node/syncing {syncing}")
    health = fetch("node/health", "GET", "/eth/v1/node/health")[0]
    if health != (200 if distance <= 1 else 206):
        raise AssertionError(f"[http] node/health {health} at distance {distance}")
    # The self-tuning control plane's one read ([autotune] measured the
    # walk's lookahead earlier in this process; the cache holds it).
    from lighthouse_tpu_torch import autotune

    status, _, body = http_fetch(server.port, "GET", "/lighthouse/autotune")
    if status != 200:
        raise AssertionError(f"[http] /lighthouse/autotune: HTTP {status}")
    tune = json.loads(body)["data"]
    want_keys = {"mode", "evaluations", "vocabularies", "warmups", "decisions", "pin",
                 "fq_backend", "walk_lookahead", "admission"}
    measured = autotune.cached_walk_lookahead() if device == "cuda" else None
    if set(tune) != want_keys or tune["fq_backend"] is not None or \
            tune["walk_lookahead"] != measured or "sha256_pairs" not in tune["vocabularies"]:
        raise AssertionError(f"[http] /lighthouse/autotune {sorted(tune)}: walk "
                             f"{tune.get('walk_lookahead')}, measured {measured}")
    genesis = get("beacon/genesis", "/eth/v1/beacon/genesis")["data"]
    if genesis["genesis_time"] != str(int(state.genesis_time)) or \
            genesis["genesis_validators_root"] != \
            "0x" + bytes(state.genesis_validators_root).hex():
        raise AssertionError(f"[http] beacon/genesis {genesis}")
    got = cached_twice("states/head/root", "GET", "/eth/v1/beacon/states/head/root")
    if got["data"]["root"] != "0x" + state.hash_tree_root().hex():
        raise AssertionError(f"[http] states/head/root {got}")
    fc = get("finality_checkpoints", "/eth/v1/beacon/states/head/finality_checkpoints")
    want = {"previous_justified": to_json(state.previous_justified_checkpoint),
            "current_justified": to_json(state.current_justified_checkpoint),
            "finalized": to_json(state.finalized_checkpoint)}
    if fc["data"] != want:
        raise AssertionError(f"[http] finality_checkpoints {fc['data']} != {want}")
    for i in (0, 1, n // 2, n - 1):
        v = get(f"validators/{i}", f"/eth/v1/beacon/states/head/validators/{i}")["data"]
        if (v["index"], v["balance"], v["validator"]) != \
                (str(i), str(int(state.balances[i])), to_json(state.validators[i])):
            raise AssertionError(f"[http] validators/{i} {v}")
    ids = rng.sample(range(n), HTTP_IDS)
    bal = get("validator_balances", "/eth/v1/beacon/states/head/validator_balances?id="
              + ",".join(map(str, ids)))["data"]
    if bal != [{"index": str(i), "balance": str(int(state.balances[i]))} for i in ids]:
        raise AssertionError("[http] validator_balances != the state's")
    committees = cached_twice("committees", "GET",
                              f"/eth/v1/beacon/states/head/committees?slot={slot}")["data"]
    want = [{"index": str(c), "slot": str(slot),
             "validators": [str(int(v)) for v in h.get_beacon_committee(state, slot, c, spec)]}
            for c in range(count)]
    if committees != want or len(committees) != count:
        raise AssertionError(f"[http] committees: {len(committees)} != the state's {count}")
    duty_of = {}
    while len(duty_of) < HTTP_IDS:
        s_, c_ = start + rng.randrange(spec.slots_per_epoch), rng.randrange(count)
        committee = h.get_beacon_committee(state, s_, c_, spec)
        pos = rng.randrange(len(committee))
        duty_of.setdefault(int(committee[pos]), (s_, c_, pos, len(committee)))
    duties = cached_twice("duties/attester", "POST",
                          f"/eth/v1/validator/duties/attester/{epoch}",
                          [str(v) for v in duty_of])["data"]
    got = {int(d["validator_index"]): (int(d["slot"]), int(d["committee_index"]),
                                       int(d["validator_committee_index"]),
                                       int(d["committee_length"])) for d in duties}
    if len(duties) != HTTP_IDS or got != duty_of or \
            any(d["committees_at_slot"] != str(count) for d in duties):
        raise AssertionError("[http] attester duties != the committees")
    reward_ids = rng.sample(range(n), HTTP_IDS)
    rewards = timed("rewards/attestations", "POST",
                    f"/eth/v1/beacon/rewards/attestations/{epoch - 1}",
                    lambda: client.post(f"/eth/v1/beacon/rewards/attestations/{epoch - 1}",
                                        [str(i) for i in reward_ids]))["data"]
    t = time.perf_counter()
    direct = json.loads(json.dumps(attestation_rewards(state, spec, reward_ids)))
    direct_s = time.perf_counter() - t
    if rewards != direct:
        raise AssertionError("[http] rewards/attestations != rewards.attestation_rewards")
    header = get("headers/head", "/eth/v1/beacon/headers/head")["data"]
    msg = signed.message
    if header["root"] != "0x" + root.hex() or header["header"]["message"] != {
            "slot": str(int(msg.slot)), "proposer_index": str(int(msg.proposer_index)),
            "parent_root": "0x" + bytes(msg.parent_root).hex(),
            "state_root": "0x" + bytes(msg.state_root).hex(),
            "body_root": "0x" + msg.body.hash_tree_root().hex()}:
        raise AssertionError(f"[http] headers/head {header}")
    raw_block, version = timed("blocks/head (SSZ)", "GET", "/eth/v2/beacon/blocks/head",
                               lambda: client.get_ssz("/eth/v2/beacon/blocks/head"))
    if raw_block != signed.as_ssz_bytes() or version != type(msg).fork_name:
        raise AssertionError("[http] blocks/head: the SSZ body != the imported block's")
    blobs = get("blob_sidecars/head", "/eth/v1/beacon/blob_sidecars/head")["data"]
    if blobs != [to_json(sc) for sc in sidecars]:
        raise AssertionError("[http] blob_sidecars/head != the six sidecars")
    # The checkpoint-sync download.
    t = time.perf_counter()
    state_ssz, version = timed("debug/beacon/states/head (SSZ)", "GET",
                               "/eth/v2/debug/beacon/states/head",
                               lambda: client.get_ssz("/eth/v2/debug/beacon/states/head"))
    download_s = time.perf_counter() - t
    if state_ssz != ref_ssz or version != type(state).fork_name:
        raise AssertionError("[http] the SSZ state download != the host run's post-state")
    misses = cache.misses
    grants = device_pipeline.ARBITER.snapshot()["grants"].get("http_api", 0) - grants0
    if grants != misses or misses != len(first_cached):
        raise AssertionError(f"[http] arbiter grants {grants}, cache misses {misses}, "
                             f"first asks of cached routes {first_cached}")
    log(f"[http] {card}: HttpApiServer on {server.url} (a BeaconProcessor of 2 workers, "
        f"the response cache on) read by BeaconNodeHttpClient: version, syncing (head "
        f"{slot}, distance {distance}), health {health}, genesis, the head state's root and "
        f"finality checkpoints, validators {[0, 1, n // 2, n - 1]}, {HTTP_IDS} balances, the "
        f"{count} committees of slot {slot}, {HTTP_IDS} attester duties of epoch {epoch}, "
        f"{HTTP_IDS} attestation rewards of epoch {epoch - 1} (rewards.attestation_rewards "
        f"called directly: {direct_s:.2f} s), the head's header, block (SSZ) and "
        f"{len(blobs)} blob sidecars: each equal to the node's own")
    log(f"[http] the response cache: states/head/root, the committees and the attester "
        f"duties asked twice, each second answer a hit (byte for byte, "
        f"http_response_cache_hits_total +1, no handler run); {misses} misses, each through "
        f"api_arbiter_slot('http_api'): the arbiter's http_api grants +{grants}")
    log(f"[http] the checkpoint-sync download GET /eth/v2/debug/beacon/states/head as SSZ: "
        f"{len(state_ssz)} bytes in {download_s:.2f} s ({len(state_ssz) / 1e6 / download_s:.1f} "
        f"MB/s), byte for byte the host run's post-state")

    # Three attestations to the pool, verified on the card, while the
    # profiler runs over the API.  A short capture first: the profiler's
    # first start in the process (CUPTI's) would eat into the window.
    warm = http_fetch(server.port, "POST", "/lighthouse/device/profile?seconds=0.05")
    if warm[0] != 200:
        raise AssertionError(f"[http] the warm-up profile: HTTP {warm[0]}")
    warm_s = json.loads(warm[2])["data"]["seconds"]
    prof = {}

    def profile():
        prof["answer"] = http_fetch(
            server.port, "POST", f"/lighthouse/device/profile?seconds={HTTP_PROFILE_S}")

    mark = runtime_mark()
    cuda_fq.reset_launch_counts()
    profiler = threading.Thread(target=profile, name="http-profile")
    profiler.start()
    time.sleep(0.5)
    status, _, body = timed(
        "pool/attestations (POST)", "POST", "/eth/v1/beacon/pool/attestations",
        lambda: http_fetch(server.port, "POST", "/eth/v1/beacon/pool/attestations",
                           [to_json(a) for a in posted]))
    post_s = seconds[-1][1]
    launches = dict(cuda_fq.LAUNCHES)
    profiler.join(timeout=120)
    answer = json.loads(body)
    if status != 400 or [f["index"] for f in answer.get("failures", [])] != \
            [HTTP_ATTESTERS - 1]:
        raise AssertionError(f"[http] the attestation POST: HTTP {status} {answer}")
    records = [r for r in assert_on_device("[http] attestations", mark)
               if r["op"] == "bls_verify"]
    if [(r["n_live"], r["verdict"]) for r in records] != \
            [(1, True)] * (HTTP_ATTESTERS - 1) + [(1, False)]:
        raise AssertionError(f"[http] the attestations' records "
                             f"{[(r['n_live'], r['verdict']) for r in records]}")
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[http] {name} was not launched for the attestations")
    good = [a.as_ssz_bytes() for _, _, a in atts[:-1]]
    if [a.as_ssz_bytes() for a in published] != good:
        raise AssertionError(f"[http] publish_attestation_fn received {len(published)}")
    # The pool aggregates votes of one committee: each committee's entry
    # is its good votes' (their bits' union; the vote itself where a
    # committee gave one, as at mainnet width).
    pool = get("pool/attestations", f"/eth/v1/beacon/pool/attestations?slot={slot}")["data"]
    want = {}
    for _, c, a in atts[:-1]:
        want.setdefault(c, []).append(a)
    got = {int(a["data"]["index"]): container_from_json(case.types.Attestation, a)
           for a in pool}
    for c, votes in want.items():
        union = [any(bits) for bits in zip(*(list(v.aggregation_bits) for v in votes))]
        entry = got.get(c)
        if entry is None or entry.data != votes[0].data or \
                list(entry.aggregation_bits) != union or \
                (len(votes) == 1 and entry.as_ssz_bytes() != votes[0].as_ssz_bytes()):
            raise AssertionError(f"[http] the pool's entry of committee {c}: {entry}")
    if sorted(got) != sorted(want):
        raise AssertionError(f"[http] the pool at slot {slot} holds committees {sorted(got)}")
    batches = get("device/batches",
                  f"/lighthouse/device/batches?op=bls_verify&limit={HTTP_ATTESTERS}")["data"]
    if [r["seq"] for r in batches] != [r["seq"] for r in reversed(records)]:
        raise AssertionError(f"[http] /lighthouse/device/batches "
                             f"{[r['seq'] for r in batches]}")
    if profiler.is_alive() or prof.get("answer", (0,))[0] != 200:
        raise AssertionError(f"[http] the profile: {prof.get('answer')}")
    captured = json.loads(prof["answer"][2])["data"]
    trace_path = captured["path"]
    with open(trace_path, "rb") as f:
        trace = f.read()
    fq_events = trace.count(b"fq_mul_kernel")
    if not fq_events and device != "cpu":
        raise AssertionError(f"[http] the profile's trace ({len(trace)} bytes, captured in "
                             f"{captured['seconds']} s; the warm-up {warm_s} s) names no "
                             f"fq_mul kernel")
    stages = {k: sum(r["stages_s"][k] for r in records)
              for k in ("setup", "dispatch", "wait", "verdict")}
    health_data = get("lighthouse/health", "/lighthouse/health")["data"]
    log(f"[http] {card}: POST /eth/v1/beacon/pool/attestations with {HTTP_ATTESTERS} "
        f"attestations of slot {slot} for the head (validators "
        f"{[v for v, _, _ in atts]}, committees {[c for _, c, _ in atts]}, signed on the host "
        f"in {sign_s:.2f} s; the last under another member's signature): HTTP 400 naming "
        f"index {HTTP_ATTESTERS - 1} only, in {post_s:.2f} s; {len(records)} single-set "
        f"supervised bls_verify batches on the card, verdicts "
        f"{[r['verdict'] for r in records]}, no host fallback, breakers closed; stages "
        f"summed: setup {stages['setup']:.3f} s, device "
        f"{stages['dispatch'] + stages['wait']:.3f} s, verdict {stages['verdict']:.3f} s; "
        f"Fq launches {launches}; publish_attestation_fn got the {len(published)} good "
        f"ones, the pool at slot {slot} holds them, /lighthouse/device/batches lists the "
        f"{len(batches)} records")
    log(f"[http] POST /lighthouse/device/profile?seconds={HTTP_PROFILE_S} beside the POST "
        f"(after a 0.05 s warm-up capture, {warm_s} s with the profiler's start): 200 in "
        f"{captured['seconds']} s, {trace_path} ({len(trace)} bytes), {fq_events} events name "
        f"fq_mul_kernel")
    log(f"[http] /lighthouse/health on the card's machine: {json.dumps(health_data)}")
    for label, wall, server_s in seconds:
        log(f"[http]   {wall:9.4f} s client {server_s:9.4f} s server  {label}")
    return {"state_ssz": state_ssz, "download_s": download_s, "post_s": post_s,
            "launches": launches, "stages_s": stages,
            "seconds": {label: [wall, served] for label, wall, served in seconds}}


#: The beacon-node client's calls a validator client makes, and of them the
#: submissions, whose supervised batches :class:`VcCalls` collects.
VC_CALLS = ("validators", "attester_duties", "proposer_duties", "sync_duties",
            "prepare_beacon_proposer", "produce_block", "publish_block", "attestation_data",
            "submit_attestations", "block_root", "submit_sync_committee_messages",
            "aggregate_attestation", "publish_aggregate_and_proofs",
            "sync_committee_contribution", "publish_contribution_and_proofs")
VC_SUBMISSIONS = ("publish_block", "submit_attestations", "submit_sync_committee_messages",
                  "publish_aggregate_and_proofs", "publish_contribution_and_proofs")


class VcCalls:
    """Record each call a validator client makes through ``client`` (a
    ``BeaconNodeHttpClient``) for the length of a ``with`` block: its name,
    arguments, answer and seconds, what each key of ``spans`` (filled by a
    :class:`Patched` around it) grew by during it, and for a submission the
    supervised ``bls_verify`` batches it caused, each checked on the card
    (:func:`assert_on_device`; not where ``on_device`` is False)."""

    def __init__(self, label: str, client, spans: dict, on_device: bool = True):
        self.label, self.client, self.spans, self.calls = label, client, spans, []
        self.on_device = on_device

    def _wrap(self, name: str, fn):
        def run(*args, **kw):
            before, mark = dict(self.spans), runtime_mark()
            t = time.perf_counter()
            out = fn(*args, **kw)
            call = {"name": name, "args": args, "kw": kw, "out": out,
                    "s": time.perf_counter() - t,
                    "spans": {k: v - before.get(k, 0) for k, v in self.spans.items()
                              if v != before.get(k, 0)}}
            if name in VC_SUBMISSIONS and self.on_device:
                call["records"] = [r for r in assert_on_device(f"{self.label} {name}", mark)
                                   if r["op"] == "bls_verify"]
            self.calls.append(call)
            return out
        return run

    def __enter__(self):
        for name in VC_CALLS:
            setattr(self.client, name, self._wrap(name, getattr(self.client, name)))
        return self

    def __exit__(self, *exc):
        for name in VC_CALLS:
            delattr(self.client, name)
        return False

    def named(self, name: str) -> list:
        return [c for c in self.calls if c["name"] == name]

    def verdicts(self, name: str) -> list:
        """(sets, verdict) of each batch the calls ``name`` caused."""
        return [(r["n_live"], r["verdict"]) for c in self.named(name) for r in c["records"]]

    def batches(self) -> list:
        """(call, its batches' (sets, verdict)) of each submission."""
        return [(c["name"], [(r["n_live"], r["verdict"]) for r in c["records"]])
                for c in self.calls if "records" in c]


def request_seconds() -> dict:
    """``http_api_request_seconds``' (count, seconds) for each (method,
    route) it has seen."""
    from lighthouse_tpu_torch import metrics

    hist = metrics.HTTP_REQUEST_SECONDS
    with hist._lock:
        return {key: (s["n"], s["sum"]) for key, s in hist._series.items()}


def served_since(before: dict, requests: int) -> dict:
    """The server's (count, seconds) by route since ``before`` (waiting up
    to 5 s for its count of ``requests``, observed after the reply)."""
    deadline = time.time() + 5
    while True:
        now = request_seconds()
        out = {dict(k)["method"] + " " + dict(k)["route"]: (n - before.get(k, (0, 0.0))[0],
                                                            t - before.get(k, (0, 0.0))[1])
               for k, (n, t) in now.items() if n != before.get(k, (0, 0.0))[0]}
        if sum(n for n, _ in out.values()) >= requests or time.time() > deadline:
            return out
        time.sleep(0.005)


def pool_at(port: int, types, slot: int) -> dict:
    """``GET /eth/v1/beacon/pool/attestations?slot=`` as {committee:
    attestation}."""
    from lighthouse_tpu_torch.http_api import container_from_json

    status, _, body = http_fetch(port, "GET", f"/eth/v1/beacon/pool/attestations?slot={slot}")
    if status != 200:
        raise AssertionError(f"[vc] the pool at slot {slot}: HTTP {status}")
    return {int(a["data"]["index"]): container_from_json(types.Attestation, a)
            for a in json.loads(body)["data"]}


def vc_keys(case, chain, slot: int, count: int) -> list:
    """The first ``count`` members, in validator order, of slot ``slot``'s
    committees on ``chain``'s head state that the case holds a key for, that
    are not slashed and that the node has not seen attest in the epoch
    ([network]'s double vote is one of them)."""
    from lighthouse_tpu_torch.consensus import helpers as h

    spec, state = case.spec, chain.head_state
    epoch = h.compute_epoch_at_slot(slot, spec)
    members = {int(v) for c in range(h.get_committee_count_per_slot(state, epoch, spec))
               for v in h.get_beacon_committee(state, slot, c, spec)}
    keyed = sorted(v for v in members
                   if v in case.keys.secret and not state.validators[v].slashed
                   and not chain.observed.attesters.is_known(epoch, v))
    if len(keyed) < count:
        raise AssertionError(f"[vc] {len(keyed)} keyed members in slot {slot}'s committees")
    return keyed[:count]


def expected_duties(state, spec, ours: list, epoch: int) -> tuple:
    """The node's own duties of ``ours`` from ``state`` (the head): the
    attester duties of ``epoch`` and ``epoch + 1`` (fixed one epoch ahead)
    as {epoch: sorted (validator, slot, committee, length, committees,
    position)}, the proposers of ``epoch`` as [(slot, validator)], and the
    sync-committee positions as {validator: [positions]}."""
    from lighthouse_tpu_torch.consensus import helpers as h

    wanted, per_slot = set(ours), spec.slots_per_epoch
    attesters = {}
    for e in (epoch, epoch + 1):
        count = h.get_committee_count_per_slot(state, e, spec)
        rows = []
        for slot in range(e * per_slot, (e + 1) * per_slot):
            for c in range(count):
                committee = [int(v) for v in h.get_beacon_committee(state, slot, c, spec)]
                rows += [(v, slot, c, len(committee), count, pos)
                         for pos, v in enumerate(committee) if v in wanted]
        attesters[e] = sorted(rows)
    # get_beacon_proposer_index's computation, the active set found once
    # (the helper scans the 2^20 validators again at each uncached slot).
    active = h.get_active_validator_indices(state, epoch)
    seed = h.get_seed(state, epoch, h.DOMAIN_BEACON_PROPOSER, spec)
    proposers = [(slot, int(h.compute_proposer_index(
        state, active, h.hash(seed + h.uint_to_bytes(slot)), spec)))
        for slot in range(epoch * per_slot, (epoch + 1) * per_slot)]
    index_of = {bytes(state.validators[v].pubkey): v for v in ours}
    sync = {}
    for pos, pk in enumerate(state.current_sync_committee.pubkeys):
        if bytes(pk) in index_of:
            sync.setdefault(index_of[bytes(pk)], []).append(pos)
    return attesters, proposers, sync


def phase_vc(card: str, case, chain, clock, served, tmp: str) -> dict:
    """[vc] on [chain]'s node after [http], on [http]'s server (see the
    module docstring): VC_KEYS keys imported as EIP-2335 keystores through
    the keymanager API into an empty ``ValidatorStore``, then one slot of
    duty of a ``ValidatorClient`` polling the node over HTTP, every
    submission verified on the card; the duties, the summary, the pool and
    the slashing protection (an EIP-3076 database on a lockbox file under
    ``tmp``) checked.  The kernels' launch counts are set to 0 just before
    ``run_slot`` and read just after."""
    from concurrent.futures import ThreadPoolExecutor

    from lighthouse_tpu_torch.chain import beacon_chain as bc_mod
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.crypto import keystore as ks
    from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient
    from lighthouse_tpu_torch.ops import cuda_fq
    from lighthouse_tpu_torch.scheduler import admission
    from lighthouse_tpu_torch.store import LockboxStore
    from lighthouse_tpu_torch.validator_client import (
        SlashingProtectionDB,
        SlashingProtectionError,
        ValidatorClient,
    )
    from lighthouse_tpu_torch.validator_client.keymanager import (
        KeymanagerClient,
        KeymanagerServer,
    )

    server, processor, published = served
    spec, types = case.spec, case.types
    state = chain.head_state
    slot = int(state.slot) + 1
    epoch = h.compute_epoch_at_slot(slot, spec)
    gvr = chain.genesis_validators_root
    ours = vc_keys(case, chain, slot, VC_KEYS)
    pubkeys = [bytes(state.validators[v].pubkey) for v in ours]

    # The keys: EIP-2335 keystores at the default work factor, imported over
    # the keymanager API into the client's empty store; one thread a key
    # on each side (hashlib's scrypt releases the GIL).
    workers = ThreadPoolExecutor(VC_KEYS)
    db_store = LockboxStore(str(Path(tmp) / "slashing_protection.db"))
    keymanager = None
    try:
        t = time.perf_counter()
        keystores = list(workers.map(
            lambda v_pk: ks.encrypt(case.keys.secret[v_pk[0]].to_bytes(32, "big"),
                                    VC_PASSWORD, path=f"m/12381/3600/{v_pk[0]}/0/0",
                                    pubkey=v_pk[1]),
            zip(ours, pubkeys)))
        encrypt_s = time.perf_counter() - t
        kdf = keystores[0]["crypto"]["kdf"]
        bn = BeaconNodeHttpClient(server.url, timeout=HTTP_TIMEOUT_S)
        vc = ValidatorClient(keys=[], beacon_nodes=[bn], spec=spec, types=types,
                             genesis_validators_root=gvr,
                             slashing_db=SlashingProtectionDB(store=db_store))
        keymanager = KeymanagerServer(store=vc.store, genesis_validators_root=gvr,
                                      preparation=vc.preparation, blocks=vc.blocks).start()
        km = KeymanagerClient(keymanager.url, keymanager.token, timeout=HTTP_TIMEOUT_S)
        if km.list_keystores():
            raise AssertionError("[vc] the client's store is not empty before the import")
        t = time.perf_counter()
        statuses = [st for answer in workers.map(
            lambda keystore: km.import_keystores([keystore], [VC_PASSWORD]), keystores)
            for st in answer]
        import_s = time.perf_counter() - t
        listed = [bytes.fromhex(k["validating_pubkey"][2:]) for k in km.list_keystores()]
        if [st["status"] for st in statuses] != ["imported"] * VC_KEYS or \
                sorted(listed) != sorted(pubkeys) or sorted(vc.store.pubkeys) != sorted(pubkeys):
            raise AssertionError(f"[vc] the keystore import: {statuses}, listed {len(listed)}")
        official = Path(__file__).resolve().parent / "tests" / "vectors" / "conformance" / \
            "tests" / "general" / "phase0" / "keystore" / "eip2335" / "official"
        vectors_s = {}
        for name in ("scrypt", "pbkdf2"):
            vector = json.loads((official / name / "keystore.json").read_text())
            meta = json.loads((official / name / "meta.json").read_text())
            t = time.perf_counter()
            secret = ks.decrypt(vector, meta["password"])
            vectors_s[name] = time.perf_counter() - t
            if secret.hex() != meta["secret"]:
                raise AssertionError(f"[vc] the official {name} keystore decrypts to "
                                     f"{secret.hex()}")
        log(f"[vc] {card}: validators {ours} (the first {VC_KEYS} keyed, unslashed members of "
            f"slot {slot}'s committees the node has not seen attest) as EIP-2335 keystores "
            f"({kdf['function']} n={kdf['params']['n']}, r={kdf['params']['r']}) encrypted in {encrypt_s:.2f} s "
            f"({VC_KEYS} threads), imported through {VC_KEYS} concurrent POST /eth/v1/keystores "
            f"into the client's empty store in {import_s:.2f} s (the server's decrypts), "
            f"GET /eth/v1/keystores lists the "
            f"{len(listed)}; the official EIP-2335 vectors decrypt to their secrets: scrypt "
            f"{vectors_s['scrypt']:.2f} s, pbkdf2 {vectors_s['pbkdf2']:.2f} s (hashlib)")

        # One slot of duty, the state copies and slot processing timed apart.
        # (The pool at the slot already holds [network]'s double vote.)
        clock.set_slot(slot)
        pooled = pool_at(server.port, types, slot)
        state_cls = type(state)
        targets = [(state_cls, "copy", "copy"), (bc_mod, "process_slots", "process_slots"),
                   (per_slot, "process_slots", "process_slots"),
                   (vc.store, "_raw_sign", "sign")]
        shed0 = metrics_total(admission.HTTP_REQUESTS_SHED)
        seconds0 = request_seconds()
        published0 = len(published)
        mark = runtime_mark()
        with Patched({}, targets) as spans, VcCalls("[vc]", bn, spans) as rec:
            cuda_fq.reset_launch_counts()
            t = time.perf_counter()
            summary = vc.run_slot(slot)
            slot_s = time.perf_counter() - t
            launches = dict(cuda_fq.LAUNCHES)
        served_s = served_since(seconds0, len(rec.calls))
        records = [r for r in assert_on_device("[vc]", mark) if r["op"] == "bls_verify"]
        shed = metrics_total(admission.HTTP_REQUESTS_SHED) - shed0

        # The duties: the node's own objects for the client's validators.
        t = time.perf_counter()
        attesters, proposers, sync = expected_duties(state, spec, ours, epoch)
        expected_s = time.perf_counter() - t
        for e in (epoch, epoch + 1):
            got = sorted((d.validator_index, d.slot, d.committee_index, d.committee_length,
                          d.committees_at_slot, d.validator_committee_index)
                         for duties in vc.duties._attesters.get(e, {}).values() for d in duties)
            if got != attesters[e] or len(got) != VC_KEYS:
                raise AssertionError(f"[vc] the attester duties of epoch {e}: {got} != "
                                     f"{attesters[e]}")
        answered = [(int(d["slot"]), int(d["validator_index"]))
                    for d in rec.named("proposer_duties")[0]["out"]["data"]]
        mine = {s: bytes(state.validators[v].pubkey) for s, v in proposers if v in ours}
        if answered != proposers or vc.duties._proposers.get(epoch) != mine:
            raise AssertionError(f"[vc] the proposer duties of epoch {epoch}: {answered}")
        period = epoch // spec.preset.epochs_per_sync_committee_period
        got_sync = {d.validator_index: d.positions
                    for d in vc.sync_committee._sync_duties.get(period, [])}
        if got_sync != sync:
            raise AssertionError(f"[vc] the sync duties {got_sync} != {sync}")

        # The summary, the submissions and their batches on the card.
        n_agg, n_contrib = summary["aggregates"], summary["sync_contributions"]
        want = {"slot": slot, "proposed": None, "attestations": VC_KEYS,
                "aggregates": n_agg, "sync_messages": len(sync),
                "sync_contributions": n_contrib}
        if summary != want:
            raise AssertionError(f"[vc] the summary {summary} != {want}")
        submitted = [a for c in rec.named("submit_attestations") for a in c["args"][0]]
        if rec.verdicts("submit_attestations") != [(1, True)] * VC_KEYS or \
                rec.verdicts("submit_sync_committee_messages") != \
                ([(len(sync), True)] if sync else []) or \
                rec.verdicts("publish_aggregate_and_proofs") != [(3, True)] * n_agg or \
                rec.verdicts("publish_contribution_and_proofs") != \
                ([(3 * n_contrib, True)] if n_contrib else []) or \
                len(records) != sum(len(c.get("records", ())) for c in rec.calls):
            raise AssertionError(f"[vc] the batches {rec.batches()}, {len(records)} in the "
                                 f"flight record")
        for name in KERNELS:
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"[vc] {name} was not launched in the client's slot")
        if [a.as_ssz_bytes() for a in published[published0:]] != \
                [a.as_ssz_bytes() for a in submitted]:
            raise AssertionError(f"[vc] publish_attestation_fn got "
                                 f"{len(published) - published0}")
        pool = pool_at(server.port, types, slot)
        by_committee = {}
        for a in submitted:
            by_committee.setdefault(int(a.data.index), []).append(a)
        for c, votes in by_committee.items():
            earlier = [pooled[c]] if c in pooled else []
            union = [any(bits) for bits in zip(*(list(v.aggregation_bits)
                                                 for v in votes + earlier))]
            entry = pool.get(c)
            if entry is None or entry.data != votes[0].data or \
                    list(entry.aggregation_bits) != union or \
                    (len(votes) == 1 and not earlier and
                     entry.as_ssz_bytes() != votes[0].as_ssz_bytes()):
                raise AssertionError(f"[vc] the pool's entry of committee {c}: bits at "
                                     f"{[i for i, b in enumerate(entry.aggregation_bits) if b]}"
                                     if entry is not None else f"[vc] no pool entry for {c}")
        if sorted(pool) != sorted(set(by_committee) | set(pooled)) or \
                len(submitted) != VC_KEYS:
            raise AssertionError(f"[vc] the pool at slot {slot} holds committees {sorted(pool)}")

        # Slashing protection: a second vote at the slot for another head.
        other = submitted[0].data.copy()
        other.beacon_block_root = bytes(chain.block_root_at_slot(slot - 2) or
                                        chain.genesis_block_root)
        try:
            vc.store.sign_attestation(bytes(state.validators[ours[0]].pubkey), other)
        except SlashingProtectionError as err:
            refusal = str(err)
        else:
            raise AssertionError("[vc] a second vote at the slot was signed")
        bn.attestation_data = lambda *a, **kw: other
        before = (runtime_mark()["seq"], len(published))
        try:
            with VcCalls("[vc] double", bn, {}) as again:
                revoted = vc.attester.attest(slot)
        finally:
            vars(bn).pop("attestation_data", None)
        if revoted or again.named("submit_attestations") or \
                (runtime_mark()["seq"], len(published)) != before:
            raise AssertionError(f"[vc] the double vote reached the node: {revoted}")
        interchange = json.loads(vc.store.slashing_db.export_json(gvr))
        votes = {bytes.fromhex(d["pubkey"][2:]): [(int(a["source_epoch"]), int(a["target_epoch"]))
                                                  for a in d["signed_attestations"]]
                 for d in interchange["data"]}
        want_votes = {}
        for a in submitted:
            pos = list(a.aggregation_bits).index(True)
            v = int(h.get_beacon_committee(state, slot, int(a.data.index), spec)[pos])
            want_votes[bytes(state.validators[v].pubkey)] = [
                (int(a.data.source.epoch), int(a.data.target.epoch))]
        if votes != want_votes:
            raise AssertionError(f"[vc] the EIP-3076 export {votes} != the votes {want_votes}")
    finally:
        workers.shutdown()
        if keymanager is not None:
            keymanager.stop()
        db_store.close()

    # Where the slot's time went.
    elected = (rec.verdicts("publish_aggregate_and_proofs")
               + rec.verdicts("publish_contribution_and_proofs"))
    stages = {k: sum(r["stages_s"][k] for r in records)
              for k in ("setup", "dispatch", "wait", "verdict")}
    log(f"[vc] {card}: ValidatorClient.run_slot({slot}) (one BeaconNodeHttpClient to "
        f"{server.url}, timeout {HTTP_TIMEOUT_S:.0f} s; the server's task spawner "
        f"{server.spawner.timeout:.0f} s) in {slot_s:.2f} s: {summary}; the attester duties of "
        f"epochs {epoch} and {epoch + 1}, the proposer duties of {epoch} ({len(mine)} of its "
        f"{len(proposers)} slots ours) and the sync duties ({len(sync)} of the {VC_KEYS} in the "
        f"sync committee, positions {sorted(sync.values())}) equal the head state's committees, "
        f"proposers and sync committee (computed in {expected_s:.2f} s); {len(submitted)} attestations POSTed, {VC_KEYS} single-set "
        f"supervised bls_verify batches on the card, "
        f"{len(rec.verdicts('submit_sync_committee_messages'))} sync batch of {len(sync)}, "
        f"{n_agg} aggregates and {n_contrib} contributions the client was elected to publish "
        f"({elected}), "
        f"every verdict True, no host fallback, breakers closed; stages summed: setup "
        f"{stages['setup']:.3f} s, device {stages['dispatch'] + stages['wait']:.3f} s, verdict "
        f"{stages['verdict']:.3f} s; Fq launches {launches}; publish_attestation_fn holds the "
        f"client's votes byte for byte, the pool at slot {slot} too (where a committee's entry "
        f"had no earlier vote; else their bits' union); signing on the host "
        f"{spans.get('sign', 0.0):.2f} s over {spans.get('sign_calls', 0)} signatures; "
        f"http_requests_shed_total +{shed:.0f}")
    log(f"[vc] slashing protection: a second vote at slot {slot} for another head refused by "
        f"the client's EIP-3076 database ({refusal}); through the attestation service nothing "
        f"signed and nothing POSTed; the interchange export lists the {len(votes)} votes")
    for c in rec.calls:
        sp = c["spans"]
        extra = "".join(f", {k} {sp[k]:.2f} s ({sp.get(k + '_calls', 0)} calls)"
                        for k in ("copy", "process_slots", "sign") if k in sp)
        batches = "".join(f", batch {r['n_live']} sets {r['verdict']} (setup "
                          f"{r['stages_s']['setup']:.3f}, device "
                          f"{r['stages_s']['dispatch'] + r['stages_s']['wait']:.3f} s)"
                          for r in c.get("records", ()))
        log(f"[vc]   {c['s']:9.4f} s client  {c['name']}{extra}{batches}")
    for route, (n, sec) in sorted(served_s.items()):
        log(f"[vc]   {sec:9.4f} s server  {route} ({n} requests)")
    return {"slot_s": slot_s, "summary": summary, "launches": launches, "stages_s": stages,
            "encrypt_s": encrypt_s, "import_s": import_s, "vectors_s": vectors_s,
            "shed": shed, "sign_s": spans.get("sign", 0.0),
            "server_s": {route: sec for route, (_, sec) in served_s.items()}}


def devnet_config(spec) -> str:
    """[client]'s ``config.yaml``: the case's (mainnet) spec with every fork
    up to Deneb at epoch 0 and mainnet's fork versions, as a consensus-specs
    config file.  ``--genesis-state`` decodes at the fork of epoch 0, so the
    Deneb state loads; at the state's epoch the fork, its domains and the
    gossip digests are mainnet's."""
    import dataclasses

    from lighthouse_tpu_torch.network_config import spec_to_yaml

    devnet = dataclasses.replace(spec, config_name="chip-smoke-devnet", altair_fork_epoch=0,
                                 bellatrix_fork_epoch=0, capella_fork_epoch=0,
                                 deneb_fork_epoch=0)
    return ("# chip_smoke [client]: mainnet, every fork up to Deneb at epoch 0\n"
            + spec_to_yaml(devnet))


def compute_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory``'s lines."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


def prometheus_values(text: str, name: str) -> dict:
    """Each sample of metric ``name`` in Prometheus text: {labels: value}."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name) and line[len(name):len(name) + 1] in ("{", " "):
            labels, _, value = line[len(name):].rpartition(" ")
            out[labels] = float(value)
    return out


class ClientCell:
    """[client]: the node the operator starts, ``python -m lighthouse_tpu_torch
    bn``, on [chain]'s post-state, in a second process beside [vc] (see the
    module docstring).  ``__init__`` writes the state ([http]'s download)
    beside a devnet ``config.yaml``, starts a ``LocalNode`` of [chain]'s
    node on a ``TcpEndpoint`` for the child to dial (the builder's endpoint
    is unsecured, as the JAX package's, so it cannot dial [wire]'s secured
    one), starts the child and runs its gates from a thread; :meth:`finish`
    joins the thread, stops the child with SIGTERM and raises what failed.
    Every result is printed after the join, so [vc]'s lines stay whole."""

    def __init__(self, card: str, chain, served, post_ssz: bytes, slashing, spec,
                 device: str = "cuda"):
        import os
        import tempfile

        import torch

        from lighthouse_tpu_torch.network import LocalNode
        from lighthouse_tpu_torch.network.tcp_transport import TcpEndpoint

        self.card, self.chain, self.device = card, chain, device
        self.kind = torch.cuda.get_device_name(0) if device == "cuda" else None
        self.slashing = slashing
        self.lines, self.out, self.error = [], {}, None
        self.t0 = time.perf_counter()
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_client_")
        state_path = os.path.join(self.dir, "state.ssz")
        with open(state_path, "wb") as f:
            f.write(post_ssz)
        with open(os.path.join(self.dir, "config.yaml"), "w") as f:
            f.write(devnet_config(spec))
        # [http]'s answers, read before [vc] starts.
        status, _, body = http_fetch(served[0].port, "GET",
                                     "/eth/v1/beacon/states/head/finality_checkpoints")
        if status != 200:
            raise AssertionError(f"[client] the node's finality checkpoints: HTTP {status}")
        self.finality = json.loads(body)["data"]
        self.node = LocalNode(peer_id="chain", chain=chain, endpoint=TcpEndpoint("chain"))
        host, port = self.node.endpoint.listen_addr
        self.argv = [sys.executable, "-m", "lighthouse_tpu_torch", "bn",
                     "--testnet-dir", self.dir, "--genesis-state", state_path,
                     "--datadir", os.path.join(self.dir, "db"), "--http-port", "0",
                     "--listen-port", "0", "--peers", f"{host}:{port}", "--aot-warmup"]
        if device == "cpu":
            self.argv += ["--device", "cpu"]
        self.log_path = os.path.join(self.dir, "bn.log")
        self.log_file = open(self.log_path, "wb")
        # The node's API waits HTTP_TIMEOUT_S for a handler, as [http]'s and
        # [vc]'s server does: its slashing POSTs copy the 2^20 state.  The
        # operator asks for the mesh over every card and the default
        # autotune mode: on one card the builder takes the mesh's
        # single-device branch.
        env = dict(os.environ, PYTHONUNBUFFERED="1",
                   LIGHTHOUSE_TPU_API_TIMEOUT_S=str(HTTP_TIMEOUT_S),
                   LIGHTHOUSE_TPU_MESH="auto", LIGHTHOUSE_TPU_AUTOTUNE="pinned",
                   LIGHTHOUSE_TPU_AOT_BUCKETS=CLIENT_WARMUP_BUCKETS)
        self.apps = compute_apps() if device == "cuda" else []
        self.child = subprocess.Popen(self.argv, stdout=self.log_file, stderr=subprocess.STDOUT,
                                      cwd=str(Path(__file__).resolve().parent), env=env)
        self.started = time.perf_counter()
        self.thread = threading.Thread(target=self._run, name="client-gates", daemon=True)
        self.thread.start()

    def say(self, text: str) -> None:
        self.lines.append(f"[client] {text}")

    def get(self, path: str, expect: int = 200):
        """A GET to the child: (seconds on the client, decoded JSON or text)."""
        t = time.perf_counter()
        status, ctype, body = http_fetch(self.port, "GET", path)
        seconds = time.perf_counter() - t
        if status != expect:
            raise AssertionError(f"[client] GET {path}: HTTP {status} {body[:200]!r}")
        return seconds, json.loads(body) if "json" in ctype else body.decode()

    def _run(self) -> None:
        try:
            self._gates()
        except BaseException as err:  # reported by finish()
            self.error = err

    def _up(self) -> float:
        """Wait for ``beacon node up`` in the child's log; returns the
        seconds since the child started and sets ``self.port``."""
        import re

        deadline = self.started + CLIENT_BOOT_S
        while time.perf_counter() < deadline:
            with open(self.log_path, "rb") as f:
                text = f.read().decode(errors="replace")
            m = re.search(r"beacon node up: http API on :(\d+)", text)
            if m is not None:
                self.port = int(m.group(1))
                return time.perf_counter() - self.started
            if self.child.poll() is not None:
                raise AssertionError(f"[client] the node exited with {self.child.returncode} "
                                     "before it was up")
            time.sleep(0.1)
        raise AssertionError(f"[client] the node was not up after {CLIENT_BOOT_S:.0f} s")

    def _warmup(self) -> dict:
        """``--aot-warmup``'s record: the node's device summary lists each
        bucket of CLIENT_WARMUP_BUCKETS as a warmup (outcome hit or miss,
        never an error) once its background thread is done, and its log
        has no failed warmup."""
        wanted = CLIENT_WARMUP_BUCKETS.split(",")
        deadline = time.perf_counter() + CLIENT_WARMUP_S
        while True:
            _, device = self.get("/lighthouse/device")
            with open(self.log_path, "rb") as f:
                text = f.read().decode(errors="replace")
            if "bucket warmup failed" in text:
                raise AssertionError("[client] the node's log: a bucket warmup failed")
            entries = {e["shape"]: e for e in device["data"]["programs"]
                       if e["op"] == "bls_verify" and e.get("source") == "warmup"}
            if all(b in entries for b in wanted):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"[client] no warmup of {wanted} after "
                                     f"{CLIENT_WARMUP_S:.0f} s: {device['data']['programs']}")
            time.sleep(0.5)
        for b in wanted:
            if entries[b].get("warmup_outcome") not in ("hit", "miss"):
                raise AssertionError(f"[client] the {b} warmup record {entries[b]}")
        return {b: {"seconds": entries[b]["compile_seconds"],
                    "outcome": entries[b]["warmup_outcome"]} for b in wanted}

    def launches(self) -> dict:
        """The node's kernel launches so far (its ``/metrics``)."""
        _, text = self.get("/metrics")
        return {labels.split('"')[1]: int(n) for labels, n in
                prometheus_values(text, "device_kernel_launches").items()}

    def _gates(self) -> None:
        import copy
        import re

        from lighthouse_tpu_torch.http_api.serde import to_json

        chain, card = self.chain, self.card
        out = self.out
        out["up_s"] = self._up()
        # the warmup's launches count with the boot's, not the POSTs'
        out["warmup"] = self._warmup()
        out["boot_launches"] = self.launches()
        with open(self.log_path, "rb") as f:
            boot_log = f.read().decode(errors="replace")
        boot = {}
        m = re.search(r"genesis state: (\d+) bytes decoded as (\w+) in ([\d.]+) s", boot_log)
        if m:
            boot["decode"] = float(m.group(3))
        m = re.search(r"kernel libraries ready in ([\d.]+) s", boot_log)
        if m:
            boot["kernels"] = float(m.group(1))
        m = re.search(r"its root in ([\d.]+) s, the chain \(store write, fork-choice anchor\) "
                      r"in ([\d.]+) s", boot_log)
        if m:
            boot["root"], boot["chain"] = float(m.group(1)), float(m.group(2))
        out["boot_s"] = boot
        self.say(f"{card}: `{' '.join(self.argv[1:])}` printed `beacon node up` "
                 f"{out['up_s']:.2f} s after it started (pid {self.child.pid}, HTTP port "
                 f"{self.port}); its log: decode {boot.get('decode', 'n/a')} s, kernel "
                 f"libraries {boot.get('kernels', 'n/a')} s, the anchor's root "
                 f"{boot.get('root', 'n/a')} s, the chain (store write, fork-choice anchor) "
                 f"{boot.get('chain', 'n/a')} s")
        if self.device == "cuda":
            # nvidia-smi names every process of this machine's PID namespace
            # with pid 1, so the node is the one compute app more than before
            # it started; its own API names the card its memory is on.
            apps = compute_apps()
            _, device = self.get("/lighthouse/device")
            memory = device["data"]["memory"]
            peak = memory[0].get("stats", {}).get("allocated_bytes.all.peak", 0) if memory \
                else 0
            if len(apps) != len(self.apps) + 1 or not peak or \
                    memory[0]["kind"] != self.kind:
                raise AssertionError(f"[client] nvidia-smi's compute apps {apps} (before the "
                                     f"node {self.apps}); the node's device memory {memory}")
            self.say(f"nvidia-smi --query-compute-apps: {apps}, one more than before the node "
                     f"started ({self.apps}; pids read as 1 in this machine's PID namespace); "
                     f"the node's /lighthouse/device: {memory[0]['kind']}, "
                     f"{peak} bytes allocated at its peak")
        # LIGHTHOUSE_TPU_MESH=auto on one card: the builder configured the
        # mesh and took its single-device branch; the autotune mode pinned.
        _, device = self.get("/lighthouse/device")
        mesh, tune = device["data"]["mesh"], device["data"]["autotune"]
        cards = len(device["data"]["memory"])
        if (mesh["size"], mesh["enabled"], mesh["devices"]) != (0, False, []) or \
                (self.device == "cuda" and cards != 1) or tune["mode"] != "pinned" \
                or tune["overlay"] != {}:
            raise AssertionError(f"[client] LIGHTHOUSE_TPU_MESH=auto, AUTOTUNE=pinned: the "
                                 f"node's mesh {mesh}, autotune {tune}, {cards} device(s)")
        self.say(f"LIGHTHOUSE_TPU_MESH=auto on {cards} device(s): the node's mesh size "
                 f"{mesh['size']} (disabled, generation {mesh['generation']}); autotune "
                 f"mode {tune['mode']}, overlay {tune['overlay']}")
        self.say(f"--aot-warmup with LIGHTHOUSE_TPU_AOT_BUCKETS={CLIENT_WARMUP_BUCKETS}: the "
                 f"node's /lighthouse/device lists the warmed bucket(s) before its first batch: "
                 + ", ".join(f"{b} {w['outcome']} in {w['seconds']:.4f} s (one neutral "
                             f"supervised verify)" for b, w in out["warmup"].items())
                 + "; no failed warmup in its log")

        # Same chain.
        seconds = {}
        # The node holds its anchor's state but no signed block (as [chain]'s
        # own anchor), so, as in the JAX package, it serves no header of it.
        seconds["headers/head"], header = self.get("/eth/v1/beacon/headers/head", expect=404)
        if "genesis block body is not stored" not in header["message"]:
            raise AssertionError(f"[client] /eth/v1/beacon/headers/head: {header}")
        seconds["blocks/head/root"], head = self.get("/eth/v1/beacon/blocks/head/root")
        if head["data"]["root"] != "0x" + chain.head_root.hex():
            raise AssertionError(f"[client] the node's head {head['data']['root']}, [chain]'s "
                                 f"{chain.head_root.hex()}")
        seconds["states/head/root"], root = self.get("/eth/v1/beacon/states/head/root")
        if root["data"]["root"] != "0x" + bytes(chain.head_state.hash_tree_root()).hex():
            raise AssertionError(f"[client] the node's head state root {root['data']['root']}")
        seconds["finality_checkpoints"], fin = self.get(
            "/eth/v1/beacon/states/head/finality_checkpoints")
        if fin["data"] != self.finality:
            raise AssertionError(f"[client] finality {fin['data']} != [http]'s {self.finality}")
        seconds["syncing"], syncing = self.get("/eth/v1/node/syncing")
        distance = int(syncing["data"]["sync_distance"])
        wall_slot = (int(time.time()) - int(chain.genesis_time)) // chain.spec.seconds_per_slot
        if int(syncing["data"]["head_slot"]) != chain.head_slot() or \
                abs(distance - (wall_slot - chain.head_slot())) > 1:
            raise AssertionError(f"[client] /eth/v1/node/syncing {syncing['data']}")
        self.say(f"the same chain: head {head['data']['root'][:18]} at slot "
                 f"{syncing['data']['head_slot']} and "
                 f"its state root {root['data']['root'][:18]} are [chain]'s; the finality "
                 f"checkpoints are [http]'s; /eth/v1/node/syncing: head slot "
                 f"{syncing['data']['head_slot']}, sync distance {distance} slots (the wall "
                 f"clock's), is_syncing {syncing['data']['is_syncing']}; "
                 f"/eth/v1/beacon/headers/head HTTP 404 ({header['message']}: the anchor "
                 f"has no signed block)")

        # Verified on the card: the double vote's slashing, tampered, then as it is.
        _, before = self.get("/lighthouse/device/batches?op=bls_verify&limit=1024")
        seq0 = max([r["seq"] for r in before["data"]], default=0)
        tampered = copy.deepcopy(self.slashing)
        tampered.attestation_1.signature = bytes(self.slashing.attestation_2.signature)
        posts = {}
        for label, body, expect in (("tampered", tampered, 400), ("real", self.slashing, 200)):
            t = time.perf_counter()
            status, _, reply = http_fetch(self.port, "POST", "/eth/v1/beacon/pool/attester_slashings",
                                          body=to_json(body))
            posts[label] = time.perf_counter() - t
            if status != expect:
                raise AssertionError(f"[client] the {label} slashing: HTTP {status} "
                                     f"{reply[:300]!r}, expected {expect}")
            if label == "tampered" and b"bad signature" not in reply:
                raise AssertionError(f"[client] the tampered slashing's refusal {reply[:300]!r}")
        seconds["pool"], pool = self.get("/eth/v1/beacon/pool/attester_slashings")
        if pool["data"] != [to_json(self.slashing)]:
            raise AssertionError(f"[client] the node's pool {pool['data']}")
        launches = self.launches()
        out["post_launches"] = {k: n - out["boot_launches"].get(k, 0)
                                for k, n in launches.items()}
        if self.device == "cuda" and (
                out["boot_launches"].get("tree_hash_subtrees", 0) <= 0 or
                min(out["post_launches"].get(k, 0) for k in KERNELS) <= 0):
            raise AssertionError(f"[client] the node's kernel launches: at boot "
                                 f"{out['boot_launches']}, for the POSTs "
                                 f"{out['post_launches']}")
        _, after = self.get("/lighthouse/device/batches?op=bls_verify&limit=1024")
        records = sorted((r for r in after["data"] if r["seq"] > seq0), key=lambda r: r["seq"])
        if [(r["n_live"], r.get("verdict"), r["host_fallback"]) for r in records] != \
                [(2, False, False), (2, True, False)]:
            raise AssertionError(f"[client] the node's bls_verify records {records}")
        _, trees = self.get("/lighthouse/device/batches?op=tree_hash&limit=1024")
        if not trees["data"] or any(r["host_fallback"] for r in trees["data"]):
            raise AssertionError(f"[client] the node's tree_hash records {trees['data'][:4]}")
        _, device = self.get("/lighthouse/device")
        dev = device["data"]
        breakers = {b["op"]: b["state"] for b in dev["supervisor"]["breakers"]}
        if any(dev["host_fallbacks"].values()) or any(v != "closed" for v in breakers.values()):
            raise AssertionError(f"[client] the node's host fallbacks {dev['host_fallbacks']}, "
                                 f"breakers {breakers}")
        _, everything = self.get("/lighthouse/device/batches?limit=1024")
        ops = {}
        for r in everything["data"]:
            ops[r["op"]] = ops.get(r["op"], 0) + 1
        out["ops"] = ops
        out["records"] = records
        out["posts_s"] = posts
        stages = [r["stages_s"] for r in records]
        self.say(f"{card}: POST /eth/v1/beacon/pool/attester_slashings: the double vote's "
                 f"slashing with attestation_1 under attestation_2's signature HTTP 400 (bad "
                 f"signature) in {posts['tampered']:.2f} s, then as it is HTTP 200 in "
                 f"{posts['real']:.2f} s; GET of the pool returns it, its JSON as sent; the "
                 f"node's flight record: two 2-set bls_verify batches, verdicts [False, True], "
                 f"no host fallback, breakers closed ({sorted(breakers)}); "
                 f"{len(trees['data'])} tree_hash batches of the boot's root on the card; "
                 f"its whole flight record by op {ops} (its committees come from the host "
                 f"shuffle: no boundary)")
        self.say(f"the node's kernel launches (its /metrics): booting (the anchor's root "
                 f"and the warmup) {out['boot_launches']}; for the two POSTs "
                 f"{out['post_launches']}")
        for label, st in zip(("the first (tampered)", "the second"), stages):
            self.say(f"  {label} slashing's verify: setup {st['setup']:.4f} s, device "
                     f"{st['dispatch'] + st['wait']:.4f} s (dispatch {st['dispatch']:.4f}, "
                     f"wait {st['wait']:.4f}), verdict {st['verdict']:.4f} s")
        out["first_dispatch_s"] = stages[0]["dispatch"] + stages[0]["wait"] - (
            stages[1]["dispatch"] + stages[1]["wait"])
        self.say(f"the first POST's verify took {out['first_dispatch_s']:.4f} s of device "
                 f"stages more than the second's, after the {CLIENT_WARMUP_BUCKETS} warmup "
                 f"(the POSTs' verifies are 2-set batches)")

        # Joined.
        seconds["peer_count"], peers = self.get("/eth/v1/node/peer_count")
        connected = int(peers["data"]["connected"])
        mine = [p for p in self.node.endpoint.connected_peers() if p.startswith("bn-")]
        if connected < 1 or len(mine) != 1:
            raise AssertionError(f"[client] peer_count {peers['data']}, [chain]'s peers "
                                 f"{self.node.endpoint.connected_peers()}")
        _, identity = self.get("/eth/v1/node/identity")
        if identity["data"]["peer_id"] != mine[0]:
            raise AssertionError(f"[client] the node's identity {identity['data']['peer_id']}, "
                                 f"[chain]'s node lists {mine}")
        self.say(f"joined: the node counts {connected} connected peer(s); [chain]'s node lists "
                 f"it as {mine[0]}")

        # No runaway advance; the node's own request seconds and its RSS.
        _, text = self.get("/metrics")
        advances = prometheus_values(text, "beacon_state_advance_seconds_count")
        if any(advances.values()):
            raise AssertionError(f"[client] the node advanced its state: {advances}")
        served = {labels: value for labels, value in
                  prometheus_values(text, "http_api_request_seconds_sum").items()}
        counts = prometheus_values(text, "http_api_request_seconds_count")
        _, health = self.get("/lighthouse/health")
        rss = int(health["data"]["pid_mem_resident_set_size"])
        out["rss"] = rss
        out["seconds"] = seconds
        out["served"] = {k: (counts.get(k, 0), v) for k, v in served.items()}
        mem = dev.get("memory") or {}
        self.say(f"no state advance (beacon_state_advance_seconds: "
                 f"{sum(advances.values()):.0f} observations); the node's RSS {rss} bytes "
                 f"({rss / 2**30:.2f} GiB); its device memory {json.dumps(mem)[:300]}")
        for key, sec in seconds.items():
            self.say(f"  {sec:9.4f} s client  GET {key}")
        for key, sec in posts.items():
            self.say(f"  {sec:9.4f} s client  POST attester_slashings ({key})")
        for labels, (n, sec) in sorted(out["served"].items()):
            self.say(f"  {sec:9.4f} s node    {labels} ({n:.0f} requests)")
        # Each POST's verify against the rest of its handler (the head-state
        # copy, the JSON, the signature sets, the processing on the copy).
        post_key = [k for k in out["served"] if "attester_slashings" in k and "POST" in k]
        if post_key:
            n, total = out["served"][post_key[0]]
            verify = sum(st["setup"] + st["dispatch"] + st["wait"] + st["verdict"]
                         for st in stages)
            out["post_rest_s"] = total - verify
            self.say(f"the two POSTs on the node: {total:.2f} s, the verifies "
                     f"{verify:.3f} s, the rest (the head-state copy, the JSON, the signature "
                     f"sets, the processing on the copy) {total - verify:.2f} s")

    def tail(self) -> str:
        with open(self.log_path, "rb") as f:
            lines = f.read().decode(errors="replace").splitlines()
        return "\n".join(lines[-CLIENT_LOG_TAIL:])

    def kill(self) -> None:
        if self.child.poll() is None:
            self.child.kill()
            self.child.wait(timeout=60)

    def close(self) -> None:
        """Kill the node if it still runs; stop [chain]'s peer node; remove
        the files."""
        import shutil

        self.kill()
        self.log_file.close()
        self.node.shutdown()
        self.node.endpoint.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def abort(self) -> None:
        """Stop everything after a failure outside the gates ([vc]'s)."""
        self.kill()
        self.thread.join(timeout=60)
        self.close()

    def finish(self) -> dict:
        """Join the gates, stop the node (SIGTERM: exit code 0 within
        CLIENT_STOP_S), print every result; raises on a failed gate, after
        printing the node's log tail and killing it."""
        import signal

        try:
            self.thread.join(timeout=CLIENT_BOOT_S + 4 * HTTP_TIMEOUT_S)
            if self.thread.is_alive():
                raise AssertionError("[client] the gates did not finish")
            if self.error is not None:
                raise self.error
            self.child.send_signal(signal.SIGTERM)
            t = time.perf_counter()
            try:
                code = self.child.wait(timeout=CLIENT_STOP_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[client] the node did not stop within "
                                     f"{CLIENT_STOP_S:.0f} s of SIGTERM") from None
            self.out["stop_s"] = time.perf_counter() - t
            if code != 0:
                raise AssertionError(f"[client] the node exited with {code} on SIGTERM")
            self.say(f"SIGTERM: the node exited with 0 in {self.out['stop_s']:.2f} s")
            self.out["wall_s"] = time.perf_counter() - self.t0
            for line in self.lines:
                log(line)
            return self.out
        except BaseException:
            for line in self.lines:
                log(line)
            self.kill()
            self.log_file.flush()
            log(f"[client] the node's log, last {CLIENT_LOG_TAIL} lines:\n{self.tail()}")
            raise
        finally:
            self.close()


def sign_blinded(hs, block):
    """``block`` (blinded) signed by its proposer with the harness's keys."""
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.types.spec import DOMAIN_BEACON_PROPOSER

    slot = int(block.slot)
    state, _ = hs.chain.state_at_slot(slot)
    domain = hs._domain_at(state, DOMAIN_BEACON_PROPOSER, slot // hs.spec.slots_per_epoch)
    sig = hs._sign(int(block.proposer_index),
                   h.compute_signing_root(block.hash_tree_root(), domain))
    return hs.types.signed_blinded_block[type(block).fork_name](message=block,
                                                               signature=sig.to_bytes())


def builder_run(validators: int = HARNESS_VALIDATORS, spec=None) -> dict:
    """The builder path on a fresh harness of ``validators`` interop
    validators (``spec``: the harness's default where None) on the active
    BLS backend: a ``MockRelay`` over HTTP, the chain's
    ``BuilderHttpClient`` with the relay's key pinned; the next slot's
    blinded block from its bid (``produce_blinded_block``: the bid's
    signature verified through ``api.verify_signature_sets``), signed by
    the proposer, revealed and imported (``unblind_and_import``); then the
    next slot's blinded block with its header changed after the bid,
    refused.  Blocks carry HARNESS_GRAFFITI.  Returns the roots, the
    post-state's bytes and the refusal's error."""
    from lighthouse_tpu_torch.chain import BeaconChainHarness, BlockError
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.execution_layer.builder_client import BuilderHttpClient, MockRelay

    hs = BeaconChainHarness(validator_count=validators, spec=spec)
    chain = hs.chain
    relay = MockRelay(chain).start()
    try:
        chain.builder = BuilderHttpClient(relay.url)
        chain.builder_pubkey = relay.pubkey

        def blinded():
            slot = hs.advance_slot()
            state, _ = chain.state_at_slot(slot)
            reveal = hs.randao_reveal(state, slot, h.get_beacon_proposer_index(state, hs.spec))
            block, _ = chain.produce_blinded_block(slot, reveal, graffiti=HARNESS_GRAFFITI)
            return block

        block = blinded()
        blinded_root = block.hash_tree_root()
        root, full = chain.unblind_and_import(sign_blinded(hs, block))
        if root != blinded_root or chain.head_root != root or \
                type(full.message).__name__.startswith("Blinded"):
            raise AssertionError("[chain-harness] the unblinded block is not the signed one")
        tampered = blinded()
        tampered.body.execution_payload_header.gas_limit = 123
        try:
            chain.unblind_and_import(sign_blinded(hs, tampered))
        except BlockError as err:
            refusal = f"{type(err).__name__}: {err}"
        else:
            raise AssertionError("[chain-harness] a reveal for a changed header was imported")
        if chain.head_root != root:
            raise AssertionError("[chain-harness] the refused reveal moved the head")
        return {"blinded_root": blinded_root, "root": root,
                "state_root": chain.head_state.hash_tree_root(),
                "state_ssz": chain.head_state.as_ssz_bytes(),
                "payload_root": full.message.body.execution_payload.hash_tree_root(),
                "refusal": refusal}
    finally:
        relay.stop()


class Eth1Provider:
    """An eth1 deposit contract's follower view for ``Eth1Service``: one
    eth1 block per batch of deposits, the deposit tree in a
    ``DepositCache`` (the provider seam's shape)."""

    def __init__(self, types):
        from lighthouse_tpu_torch.eth1 import DepositCache

        self.cache, self.blocks = DepositCache(types), []

    def add_deposits(self, datas, timestamp: int) -> None:
        for d in datas:
            self.cache.insert_log(len(self.cache), d)
        self.blocks.append({"number": len(self.blocks), "hash": bytes([len(self.blocks) + 1]) * 32,
                            "timestamp": timestamp, "deposit_count": len(self.cache),
                            "deposit_root": self.cache.deposit_root()})

    def eth1_blocks(self):
        return list(self.blocks)

    def deposit_logs(self, start, end):
        return self.cache._deposit_data[start:end]


def deposit_data(types, spec, index: int):
    """Interop validator ``index``'s signed 32 ETH ``DepositData``."""
    from lighthouse_tpu_torch.consensus.genesis import (
        interop_secret_key,
        interop_withdrawal_credentials,
    )
    from lighthouse_tpu_torch.consensus.signature_sets import deposit_signature_message

    sk = interop_secret_key(index)
    pk = sk.public_key().to_bytes()
    data = types.DepositData(pubkey=pk, withdrawal_credentials=interop_withdrawal_credentials(pk),
                             amount=spec.max_effective_balance)
    data.signature = sk.sign(deposit_signature_message(data, types, spec)).to_bytes()
    return data


def eth1_run(validators: int = HARNESS_VALIDATORS) -> dict:
    """One deposit from the eth1 follower into a block, on the active BLS
    backend, on a harness of ``validators`` interop validators: the
    provider holds their genesis deposits and
    then a new one; the chain's genesis has voted in the contract's tip
    (its ``eth1_data`` counts one more deposit than its registry), so the
    first block must carry it; ``Eth1Service.update`` fills the
    ``DepositCache``, the harness produces the block (the deposit and its
    proof from the service, HARNESS_GRAFFITI), signs and imports it.
    Returns the roots, the post-state's bytes and the registry after."""
    from lighthouse_tpu_torch.chain import (
        BeaconChain,
        BeaconChainHarness,
        ManualSlotClock,
        MockExecutionEngine,
    )
    from lighthouse_tpu_torch.chain.harness import interop_genesis_state
    from lighthouse_tpu_torch.eth1 import Eth1Service

    hs = BeaconChainHarness(validator_count=validators)
    types, spec = hs.types, hs.spec
    genesis = interop_genesis_state(validators, types, spec,
                                    genesis_time=int(hs.chain.genesis_time))
    provider = Eth1Provider(types)
    old = int(genesis.genesis_time) - spec.seconds_per_eth1_block * spec.eth1_follow_distance
    provider.add_deposits([deposit_data(types, spec, i) for i in range(validators)], old - 1010)
    new = deposit_data(types, spec, ETH1_NEW_VALIDATOR)
    provider.add_deposits([new], old - 1000)
    tip = provider.blocks[-1]
    genesis.eth1_data = types.Eth1Data(deposit_root=tip["deposit_root"],
                                       deposit_count=tip["deposit_count"], block_hash=tip["hash"])
    hs.chain = BeaconChain(genesis_state=genesis, types=types, spec=spec,
                           slot_clock=ManualSlotClock(int(genesis.genesis_time),
                                                      spec.seconds_per_slot),
                           execution_engine=MockExecutionEngine())
    service = Eth1Service(provider=provider, types=types, spec=spec)
    service.update()
    hs.chain.eth1_service = service
    hs.advance_slot()
    signed = hs.produce_signed_block(graffiti=HARNESS_GRAFFITI)
    root = hs.chain.process_block(signed)
    state = hs.chain.head_state
    if len(signed.message.body.deposits) != 1 or len(state.validators) != validators + 1 \
            or bytes(state.validators[-1].pubkey) != bytes(new.pubkey) or hs.head_root != root:
        raise AssertionError(f"[chain-harness] eth1: {len(signed.message.body.deposits)} "
                             f"deposits, {len(state.validators)} validators")
    return {"root": root, "state_root": state.hash_tree_root(), "state_ssz": state.as_ssz_bytes(),
            "deposit_root": bytes(tip["deposit_root"]), "registry": len(state.validators),
            "balance": int(state.balances[-1])}


def finality_run(path, slots: int):
    """A fake-crypto harness chain of HARNESS_VALIDATORS validators extended
    by ``slots`` fully attested slots, on a HotColdDB over a lockbox file
    at ``path`` (or the harness's MemoryStore where ``path`` is None);
    returns (harness, block roots)."""
    from lighthouse_tpu_torch.chain import (
        BeaconChain,
        BeaconChainHarness,
        ManualSlotClock,
        MockExecutionEngine,
    )
    from lighthouse_tpu_torch.store import HotColdDB, LockboxStore

    hs = BeaconChainHarness(validator_count=HARNESS_VALIDATORS, fake_crypto=True)
    if path is not None:
        genesis = hs.chain.genesis_state
        hs.chain = BeaconChain(
            genesis_state=genesis, types=hs.types, spec=hs.spec,
            db=HotColdDB(hot=LockboxStore(path)),
            slot_clock=ManualSlotClock(int(genesis.genesis_time), hs.spec.seconds_per_slot),
            execution_engine=MockExecutionEngine())
    return hs, hs.extend_chain(slots)


def harness_client_slot(hs, slot: int, label: str, on_device: bool = True) -> tuple:
    """A ``ValidatorClient`` with the harness's interop keys runs slot
    ``slot`` against ``hs.chain`` served by an ``HttpApiServer``, the
    client's calls recorded (:class:`VcCalls`).  Returns (client, recorder,
    summary, seconds); the server is stopped."""
    from lighthouse_tpu_torch.consensus.genesis import interop_secret_key
    from lighthouse_tpu_torch.http_api import BeaconNodeHttpClient, HttpApiServer
    from lighthouse_tpu_torch.validator_client import ValidatorClient

    server = HttpApiServer(hs.chain).start()
    try:
        bn = BeaconNodeHttpClient(server.url, timeout=HTTP_TIMEOUT_S)
        vc = ValidatorClient(keys=[interop_secret_key(i) for i in range(HARNESS_VALIDATORS)],
                             beacon_nodes=[bn], spec=hs.spec, types=hs.types,
                             genesis_validators_root=hs.chain.genesis_validators_root)
        with VcCalls(label, bn, {}, on_device) as rec:
            t = time.perf_counter()
            summary = vc.run_slot(slot)
            seconds = time.perf_counter() - t
    finally:
        server.stop()
    return vc, rec, summary, seconds


def harness_client(card: str, real, replay, slot: int) -> dict:
    """[chain-harness]'s validator client (see the module docstring): its
    slot on ``real`` (real crypto, every submission verified on the card),
    gated against the slot's duties, then the same slot on ``replay`` (the
    fake backend) for the same roots, then a second block at the slot
    refused by its slashing protection."""
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.ops import cuda_fq
    from lighthouse_tpu_torch.validator_client import SlashingProtectionError

    chain, spec = real.chain, real.spec
    mark = runtime_mark()
    cuda_fq.reset_launch_counts()
    vc, rec, summary, slot_s = harness_client_slot(real, slot, "[chain-harness] client")
    launches = dict(cuda_fq.LAUNCHES)
    records = [r for r in assert_on_device("[chain-harness] client", mark)
               if r["op"] == "bls_verify"]
    root = bytes.fromhex(summary["proposed"] or "")
    duties = vc.duties.attester_duties_at_slot(slot, spec)
    period = (slot // spec.slots_per_epoch) // spec.preset.epochs_per_sync_committee_period
    sync = vc.sync_committee._sync_duties.get(period, [])
    sub_size = spec.preset.sync_committee_size // spec.sync_committee_subnet_count
    subcommittees = sum(len({p // sub_size for p in d.positions}) for d in sync)
    want = {"slot": slot, "proposed": root.hex(), "attestations": len(duties),
            "aggregates": len(duties), "sync_messages": len(sync),
            "sync_contributions": subcommittees}
    if not root or chain.head_root != root or summary != want or not duties or not sync:
        raise AssertionError(f"[chain-harness] the client's slot: {summary} != {want}")
    blocks = rec.verdicts("publish_block")
    if len(blocks) != 1 or blocks[0][0] < 2 or blocks[0][1] is not True or \
            rec.verdicts("submit_attestations") != [(1, True)] * len(duties) or \
            rec.verdicts("submit_sync_committee_messages") != [(len(sync), True)] or \
            rec.verdicts("publish_aggregate_and_proofs") != [(3, True)] * len(duties) or \
            rec.verdicts("publish_contribution_and_proofs") != [(3 * subcommittees, True)] or \
            len(records) != sum(len(c.get("records", ())) for c in rec.calls):
        raise AssertionError(f"[chain-harness] the client's batches {rec.batches()}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[chain-harness] the client's slot launched {launches}")
    state_root = bytes(chain.get_block(root).message.state_root)

    if replay.advance_slot() != slot:
        raise AssertionError("[chain-harness] the replay's clock is not at the client's slot")
    set_backend("fake")
    try:
        _, _, replayed, replay_s = harness_client_slot(replay, slot,
                                                       "[chain-harness] client replay", False)
    finally:
        set_backend("torch")
    if replayed != summary or replay.chain.head_root != root or \
            bytes(replay.chain.get_block(root).message.state_root) != state_root:
        raise AssertionError(f"[chain-harness] the fake-backend client's slot {replayed} != "
                             f"{summary}")

    # A second block at the slot, under the client's own slashing protection.
    pubkey = vc.duties.proposer_at_slot(slot, spec)
    parent = bytes(chain.get_block(root).message.parent_root)
    state, _ = chain.state_at_slot(slot, parent)
    other, _ = chain.produce_block(
        slot, vc.store.randao_reveal(pubkey, slot // spec.slots_per_epoch),
        graffiti=b"chip_smoke second block".ljust(32, b"\x00"), parent_root=parent,
        pre_state=state.copy())
    try:
        vc.store.sign_block(pubkey, other)
    except SlashingProtectionError as err:
        refusal = str(err)
    else:
        raise AssertionError("[chain-harness] the client signed a second block at its slot")
    log(f"[chain-harness] {card}: a ValidatorClient with the {HARNESS_VALIDATORS} interop keys "
        f"over HTTP to the real-crypto chain ran slot {slot} in {slot_s:.2f} s: {summary}: its "
        f"block the head (one bulk batch of {blocks[0][0]} sets on the card), "
        f"{len(duties)} attestations and {len(duties)} aggregates (every duty aggregates at a "
        f"committee of {duties[0].committee_length}), {len(sync)} sync messages in one batch, "
        f"{subcommittees} contributions in one batch of {3 * subcommittees} sets; "
        f"{len(records)} supervised bls_verify batches on the card, every verdict True, no host "
        f"fallback; Fq launches {launches}; on the fake backend the same slot gave the same "
        f"block and state roots in {replay_s:.2f} s; a second block at the slot refused by the "
        f"client's slashing protection ({refusal})")
    return {"slot_s": slot_s, "summary": summary, "launches": launches,
            "batches": len(records), "replay_s": replay_s}


def phase_chain_harness(card: str, device: str = "cuda") -> dict:
    """The in-process harness (SURVEY §7) on the default device (see the
    module docstring)."""
    import shutil
    import tempfile

    from lighthouse_tpu_torch.chain import AttestationError, BeaconChainHarness, BlockError
    from lighthouse_tpu_torch.consensus import helpers as h
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.bls.backends import torch_backend
    from lighthouse_tpu_torch.ops import cuda_epoch
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.store import HotColdDB, LockboxStore

    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    set_backend("torch")
    torch_backend.configure(device=device)
    th.configure(enabled=True, device=device)
    pe.configure(backend="device", device=device)
    try:
        # 1. Real crypto: a validator client's first slot, every verify on
        #    the card, then the same slot on the fake backend.
        set_backend("fake")
        replay = BeaconChainHarness(validator_count=HARNESS_VALIDATORS)
        set_backend("torch")
        real = BeaconChainHarness(validator_count=HARNESS_VALIDATORS)
        client = harness_client(card, real, replay, real.advance_slot())

        # Refusals at the next slot, each from a verdict on the card; the
        # produced blocks carry the client's votes.
        chain = real.chain
        slot = real.advance_slot()
        signed = real.produce_signed_block(sync_participation=False)
        signed.signature = bytes(signed.message.body.randao_reveal)
        mark = runtime_mark()
        try:
            chain.process_block(signed)
        except BlockError as err:
            if "bulk signature verification failed" not in str(err):
                raise
        else:
            raise AssertionError("[chain-harness] a block under another signature was accepted")
        refused = [r["verdict"] for r in assert_on_device("[chain-harness] block", mark)
                   if r["op"] == "bls_verify"]
        # The block with two attestation signatures swapped, re-signed by
        # its proposer: the bulk batch False on the card, the node as it was.
        # (A copy: a produced block holds the op pool's own attestations.)
        pre_state, _ = chain.state_at_slot(slot)
        swapped = real.produce_signed_block(sync_participation=False).message.copy()
        atts = swapped.body.attestations
        if len(atts) < 2:
            raise AssertionError(f"[chain-harness] the block carries {len(atts)} attestations")
        atts[0].signature, atts[1].signature = bytes(atts[1].signature), bytes(atts[0].signature)
        swapped = real.sign_block(swapped, pre_state)
        before = chain_snapshot(chain)
        mark = runtime_mark()
        t = time.perf_counter()
        try:
            chain.process_block(swapped)
        except BlockError as err:
            if "bulk signature verification failed" not in str(err):
                raise
        else:
            raise AssertionError("[chain-harness] a swapped attestation signature was accepted")
        swapped_s = time.perf_counter() - t
        swapped_rec = [r for r in assert_on_device("[chain-harness] swapped", mark)
                       if r["op"] == "bls_verify"]
        if [(r["n_live"] > 1, r["verdict"]) for r in swapped_rec] != [(True, False)]:
            raise AssertionError(f"[chain-harness] the swapped block's verify records "
                                 f"{[(r['n_live'], r['verdict']) for r in swapped_rec]}")
        if chain_snapshot(chain) != before:
            raise AssertionError("[chain-harness] the refused block changed the node")
        state, _ = chain.state_at_slot(slot)
        committee = h.get_beacon_committee(state, slot, 0, real.spec)
        data = chain.produce_attestation_data(slot, 0)
        others = [v for v in range(HARNESS_VALIDATORS) if v not in set(int(c) for c in committee)]
        bits = [False] * len(committee)
        bits[0] = True
        att = real.types.Attestation(
            aggregation_bits=bits, data=data,
            signature=real.sign_attestation_data(state, data, others[0]).to_bytes())
        mark = runtime_mark()
        try:
            chain.process_attestation(att)
        except AttestationError:
            pass
        else:
            raise AssertionError("[chain-harness] an attestation by another validator was accepted")
        refused += [r["verdict"] for r in assert_on_device("[chain-harness] attestation", mark)
                    if r["op"] == "bls_verify"]
        if refused != [False, False]:
            raise AssertionError(f"[chain-harness] the refusals' verdicts {refused}")
        log(f"[chain-harness] {card}: real crypto at slot {slot}: a block under another "
            f"signature (BlockError) and an attestation signed by another validator "
            f"(AttestationError) refused, both batches False on the card; the block with two of "
            f"its {len(atts)} attestations (the client's votes) under each other's signatures "
            f"(BlockError, its bulk batch of {swapped_rec[0]['n_live']} sets False on the "
            f"card, the head, the store's {before['keys']} keys and the block caches unchanged) "
            f"in {swapped_s:.2f} s")

        # 2. Five epochs to finality on the native store, then the CPU path.
        path = str(Path(tmp) / "chain.db")
        mark = runtime_mark()
        cuda_epoch.reset_launch_counts()
        t = time.perf_counter()
        card_hs, card_roots = finality_run(path, HARNESS_SLOTS)
        card_s = time.perf_counter() - t
        epoch_launches = dict(cuda_epoch.LAUNCHES)
        records = assert_on_device("[chain-harness] finality", mark)
        boundaries = [r for r in records if r["op"] in ("epoch_boundary", "epoch_boundary_leak")]
        chain = card_hs.chain
        fin, jus = card_hs.finalized_epoch(), card_hs.justified_epoch()
        if jus < 4 or fin < 3:
            raise AssertionError(f"[chain-harness] justified {jus}, finalized {fin}")
        if len(boundaries) < HARNESS_SLOTS // card_hs.spec.slots_per_epoch:
            raise AssertionError(f"[chain-harness] {len(boundaries)} boundary batches on the card")
        if min(epoch_launches.values()) <= 0:
            raise AssertionError(f"[chain-harness] epoch kernel launches {epoch_launches}")
        db = chain.db
        split = db.get_split_slot()
        spe = card_hs.spec.slots_per_epoch
        cold_slot = 2 * spe
        cold = db.load_cold_state_by_slot(cold_slot)
        held = bytes(chain.get_block(card_roots[cold_slot - 1]).message.state_root)
        if split < 3 * spe or cold is None or cold.hash_tree_root() != held:
            raise AssertionError(f"[chain-harness] the freezer: split {split}, the state at "
                                 f"{cold_slot} {cold is not None}")

        pe.configure(backend="numpy")
        th.configure(enabled=False)
        t = time.perf_counter()
        cpu_hs, cpu_roots = finality_run(None, HARNESS_SLOTS)
        cpu_s = time.perf_counter() - t
        if cpu_roots != card_roots or [
                bytes(cpu_hs.chain.get_block(r).message.state_root) for r in cpu_roots] != [
                bytes(chain.get_block(r).message.state_root) for r in card_roots]:
            raise AssertionError("[chain-harness] the card's chain != the CPU path's")
        if cpu_hs.head_state.hash_tree_root() != card_hs.head_state.hash_tree_root():
            raise AssertionError("[chain-harness] the head states differ")

        head, finalized = chain.head_root, chain.finalized_checkpoint()
        head_block = chain.get_block(head).as_ssz_bytes()
        chain.store.close()
        store = LockboxStore(path)
        try:
            db2 = HotColdDB(hot=store, types=card_hs.types, spec=card_hs.spec)
            stored = db2.get_block(head)
            head_state = db2.get_hot_state(bytes(stored.message.state_root))
            reopened = (int(head_state.finalized_checkpoint.epoch),
                        bytes(head_state.finalized_checkpoint.root))
            if stored.as_ssz_bytes() != head_block or reopened != finalized \
                    or db2.get_split_slot() != split:
                raise AssertionError(f"[chain-harness] reopened: finalized {reopened} vs "
                                     f"{finalized}, split {db2.get_split_slot()} vs {split}")
        finally:
            store.close()
        log(f"[chain-harness] {card}: fake crypto, {HARNESS_SLOTS} slots on a HotColdDB over a "
            f"lockbox file in {card_s:.2f} s: justified epoch {jus}, finalized {fin}; the "
            f"freezer's split at slot {split}, the cold state at slot {cold_slot} (a restore "
            f"point) equals the chain's; {len(boundaries)} fused boundary batches on the card, "
            f"epoch kernel launches {epoch_launches}; every block and state root equal to the "
            f"CPU path's (numpy epoch backend, host tree hashing; {cpu_s:.2f} s); reopened, the "
            f"lockbox file gives the same head block and finalized checkpoint")

        # 3. The builder path and the eth1 path, real crypto on the card,
        #    then each on the CPU path.
        set_backend("torch")
        pe.configure(backend="device", device=device)
        th.configure(enabled=True, device=device)
        mark = runtime_mark()
        t = time.perf_counter()
        builder = builder_run()
        builder_s = time.perf_counter() - t
        b_rec = [(r["n_live"], r["verdict"]) for r in assert_on_device(
            "[chain-harness] builder", mark) if r["op"] == "bls_verify"]
        mark = runtime_mark()
        t = time.perf_counter()
        eth1 = eth1_run()
        eth1_s = time.perf_counter() - t
        e_rec = [(r["n_live"], r["verdict"]) for r in assert_on_device(
            "[chain-harness] eth1", mark) if r["op"] == "bls_verify"]
        pe.configure(backend="numpy")
        th.configure(enabled=False)
        set_backend("fake")
        t = time.perf_counter()
        builder_cpu, eth1_cpu = builder_run(), eth1_run()
        path_cpu_s = time.perf_counter() - t
        set_backend("torch")
        # The builder path's batches: the bid, the import, the next bid.
        if len(b_rec) != 3 or b_rec[0] != (1, True) or b_rec[1][1] is not True or \
                b_rec[2] != (1, True) or \
                [v for _, v in e_rec] != [True]:
            raise AssertionError(f"[chain-harness] the builder path's verifies {b_rec}, the eth1 "
                                 f"block's {e_rec}")
        if builder != builder_cpu or eth1 != eth1_cpu:
            raise AssertionError(
                f"[chain-harness] the card's builder/eth1 runs != the CPU path's in "
                f"{[k for k in builder if builder[k] != builder_cpu[k]]} / "
                f"{[k for k in eth1 if eth1[k] != eth1_cpu[k]]}")
        log(f"[chain-harness] {card}: the builder path (a MockRelay over HTTP, its key pinned) "
            f"in {builder_s:.2f} s: the bid's signature verified on the card ({b_rec[0][0]} set, "
            f"True), the blinded block signed, revealed and imported (its batch of "
            f"{b_rec[1][0]} sets True on the card), the full block's root the signed blinded "
            f"root; the next slot's bid verified on the card, its header changed before "
            f"signing, the reveal refused: {builder['refusal']}; the eth1 path "
            f"in {eth1_s:.2f} s: one deposit from the provider through Eth1Service and its "
            f"DepositCache into the produced block, imported (its batch of {e_rec[0][0]} sets "
            f"True on the card), the registry {eth1['registry']} validators; every root equal to "
            f"the CPU path's (fake BLS backend, numpy epochs, host hashing; {path_cpu_s:.2f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        set_backend("torch")
        torch_backend.reset_for_tests()
        pe.reset_for_tests()
        th.configure(enabled=False)
    return {"client": client,
            "builder_s": builder_s, "eth1_s": eth1_s,
            "finality_s": card_s, "cpu_s": cpu_s, "justified": jus, "finalized": fin,
            "split": split, "boundaries": len(boundaries), "epoch_launches": epoch_launches}


def soak_scenario(seed: int = SOAK_SEED):
    """[soak]'s scenario, built with the port's public API: smoke_partition's
    fleet (3 nodes, 16 validators), slots and partition/heal, plus the fused
    epoch boundary and Merkle pair layers of SOAK_THRESHOLD_BLOCKS blocks or
    more on the runner's device from the window's first slot."""
    import dataclasses

    from lighthouse_tpu_torch.scenarios import Event, smoke_partition

    base = smoke_partition(seed=seed)
    return dataclasses.replace(base, name="soak_device", events=base.events + (
        Event(0, "epoch_device", {"enable": True, "fused": True}),
        Event(0, "state_hashing", {"enable": True,
                                   "threshold_blocks": SOAK_THRESHOLD_BLOCKS}),
    ))


def soak_run(scenario, out_dir: str, device: str) -> dict:
    """One scenario run: its head root, per-slot timeline and seconds."""
    from lighthouse_tpu_torch.scenarios import run_scenario

    t = time.perf_counter()
    artifact = run_scenario(scenario, out_dir=out_dir, device=device)
    if not artifact["passed"]:
        raise AssertionError(f"[soak] {scenario.name} on {device} failed its gates")
    return {"head_root": artifact["result"]["head_root"], "timeline": artifact["timeline"],
            "finalized": artifact["result"]["final_finalized_epoch"],
            "seconds": time.perf_counter() - t}


def kzg_blobs() -> list:
    """KZG_BLOBS distinct blobs from a seed."""
    from lighthouse_tpu_torch.crypto.kzg import BLS_MODULUS, FIELD_ELEMENTS_PER_BLOB

    rng = random.Random(0xB10B)
    return [b"".join((rng.getrandbits(256) % BLS_MODULUS).to_bytes(32, "big")
                     for _ in range(FIELD_ELEMENTS_PER_BLOB)) for _ in range(KZG_BLOBS)]


def host_commitments(kzg, blobs: list) -> tuple:
    """The blobs' commitments and proofs on the host (pure Python)."""
    commitments = [kzg.blob_to_kzg_commitment(b) for b in blobs]
    proofs = [kzg.compute_blob_kzg_proof(b, c) for b, c in zip(blobs, commitments)]
    return commitments, proofs


def cpu_child(out_dir: str) -> None:
    """The work the script hands to a child process that sees no card,
    beside the card phases: first the KZG blobs' commitments and proofs on
    the host (``kzg.json``; cut (k): ~25 s of pure Python off the main
    path), then [soak]'s CPU reference (``reference.json``):
    smoke_partition on the host routes (host tree hashing, the numpy epoch
    backend), then [soak]'s scenario on ``device="cpu"`` with the card's
    routes on the CPU (the kernels' plain versions: several minutes)."""
    import os

    import torch

    from lighthouse_tpu_torch import blackbox
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.crypto.kzg import Kzg, TrustedSetup
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.scenarios import route_device, smoke_partition

    def write(name: str, obj) -> None:
        with open(os.path.join(out_dir, name + ".tmp"), "w") as f:
            json.dump(obj, f)
        os.replace(os.path.join(out_dir, name + ".tmp"), os.path.join(out_dir, name))

    torch.set_num_threads(1)
    t = time.perf_counter()
    kzg = Kzg(TrustedSetup.from_json(KZG_SETUP.read_text(), validate=False), device=None)
    commitments, proofs = host_commitments(kzg, kzg_blobs())
    write("kzg.json", {"commitments": [c.hex() for c in commitments],
                       "proofs": [p.hex() for p in proofs], "seconds": time.perf_counter() - t})
    blackbox.configure(directory=os.path.join(out_dir, "postmortems"))
    set_backend("fake")
    th.configure(enabled=False)
    pe.configure(backend="numpy")
    out = {"smoke_host": soak_run(smoke_partition(seed=SOAK_SEED), os.path.join(out_dir, "host"),
                                  "cpu")}
    route_device("cpu")
    out["soak_cpu"] = soak_run(soak_scenario(), os.path.join(out_dir, "cpu"), "cpu")
    write("reference.json", out)


class CpuChild:
    """The child process of :func:`cpu_child`, started with the script
    (``CUDA_VISIBLE_DEVICES`` empty) and stopped when [soak] has read it or
    the script exits."""

    def __init__(self):
        import atexit
        import os
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_child_")
        self.log_path = os.path.join(self.dir, "child.log")
        self.started = time.perf_counter()
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.cpu_child({self.dir!r})"],
                cwd=str(Path(__file__).resolve().parent), stdout=out,
                stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        atexit.register(self.stop)

    def result(self, name: str, timeout: float) -> dict:
        """The child's ``name`` file, waiting up to ``timeout`` s for it."""
        import os

        path = os.path.join(self.dir, name)
        deadline = time.perf_counter() + timeout
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.perf_counter() > deadline:
                with open(self.log_path) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"no {name} from the CPU child (exit {self.proc.poll()}):"
                                     f"\n{tail}")
            time.sleep(0.5)
        with open(path) as f:
            out = json.load(f)
        out["wall_s"] = time.perf_counter() - self.started
        return out

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


@contextlib.contextmanager
def recorded_batches():
    """Every flight record made inside the block, as ``(op, host_fallback)``
    (the recorder's ring of 256 cannot hold a soak's thousands of pair
    batches, so ``record_batch`` is wrapped)."""
    from lighthouse_tpu_torch import device_telemetry

    seen, real = [], device_telemetry.record_batch

    def record_batch(*args, **kw):
        entry = real(*args, **kw)
        seen.append((entry["op"], entry["host_fallback"]))
        return entry

    device_telemetry.record_batch = record_batch
    try:
        yield seen
    finally:
        device_telemetry.record_batch = real


class LockSanitizer:
    """``LIGHTHOUSE_TPU_LOCK_SANITIZE=1`` while in the block, so every lock
    the block's objects build comes from the sanitizer (``locksmith``);
    counts the sanitized locks built and the acquisitions the sanitizer
    checked (each first acquire of a lock by a thread), and on leaving
    puts the variable back.  :meth:`check` raises on any recorded
    violation."""

    def __enter__(self):
        import itertools
        import os

        from lighthouse_tpu_torch import locksmith

        self.locksmith, self.env = locksmith, os.environ.get(locksmith.ENV_VAR)
        locksmith.reset()
        self.made, self.checked = itertools.count(), itertools.count()
        self.real = (locksmith._SanitizedLock.__init__, locksmith._note_attempt)
        init, note = self.real

        def counted_init(lock, label):
            next(self.made)
            init(lock, label)

        def counted_note(label):
            next(self.checked)
            note(label)

        locksmith._SanitizedLock.__init__, locksmith._note_attempt = counted_init, counted_note
        os.environ[locksmith.ENV_VAR] = "1"
        return self

    def __exit__(self, *exc):
        import os

        locksmith = self.locksmith
        locksmith._SanitizedLock.__init__, locksmith._note_attempt = self.real
        if self.env is None:
            os.environ.pop(locksmith.ENV_VAR, None)
        else:
            os.environ[locksmith.ENV_VAR] = self.env
        self.locks = next(self.made)
        self.acquisitions = next(self.checked)
        return False

    def check(self) -> None:
        self.locksmith.check()


def boundary_invocations() -> int:
    """Fused-boundary programs dispatched so far (the telemetry mirror's
    invocation counts of both boundary ops)."""
    from lighthouse_tpu_torch import device_telemetry

    return sum(e["invocations"] for e in device_telemetry.COMPILE_CACHE.inventory()
               if e["op"] in ("epoch_boundary", "epoch_boundary_leak"))


def soak_fault(out_dir: str, device: str = "cuda") -> dict:
    """fused_epoch_boundary on the card: its injected ``epoch_boundary``
    dispatch error raises instead of reaching the host, so the run ends at
    the window's first boundary with the fault (or the breaker it opened)
    in its artifact, the numpy composite never answering; afterwards the
    routes in force before the run are back."""
    import os

    from lighthouse_tpu_torch import device_supervisor, fault_injection
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.scenarios import fused_epoch_boundary, run_scenario

    routes = (pe._EPOCH_BACKEND, pe._FUSED_BOUNDARY, pe._DEVICE, th._ENABLED, th._DEVICE,
              th._DEVICE_MIN_BLOCKS)
    host_calls = []
    real_numpy = pe._epoch_boundary_numpy

    def spy(plan, **kw):
        host_calls.append(plan.n)
        return real_numpy(plan, **kw)

    pe._epoch_boundary_numpy = spy
    t = time.perf_counter()
    try:
        run_scenario(fused_epoch_boundary(seed=SOAK_SEED), out_dir=out_dir, device=device)
    except (fault_injection.InjectedFault, device_supervisor.RequeueWork) as e:
        raised = e
    else:
        raise AssertionError("[soak] fused_epoch_boundary passed on the card: the fault "
                             "reached no caller")
    finally:
        pe._epoch_boundary_numpy = real_numpy
    seconds = time.perf_counter() - t
    with open(os.path.join(out_dir, f"SOAK_fused_epoch_boundary_seed{SOAK_SEED}.json")) as f:
        artifact = json.load(f)
    hits = sum(p.get("hits", 0) for p in artifact["faults"] or ()
               if p.get("op") == "epoch_boundary")
    breaker = artifact["breakers"].get("epoch_boundary", {})
    bundle = artifact.get("postmortem_bundle")
    if host_calls:
        raise AssertionError(f"[soak] the numpy boundary answered on the card: {host_calls}")
    if artifact["passed"] or type(raised).__name__ not in artifact.get("failure", "") or \
            artifact["timeline"] or not hits or breaker.get("trips_total", 0) < 1 or \
            not (bundle and os.path.exists(bundle)):
        raise AssertionError(
            f"[soak] the fault run's artifact: passed {artifact['passed']}, failure "
            f"{artifact.get('failure')!r}, {len(artifact['timeline'])} slots stepped, plan hits "
            f"{hits}, breaker {breaker}, bundle {bundle}")
    after = (pe._EPOCH_BACKEND, pe._FUSED_BOUNDARY, pe._DEVICE, th._ENABLED, th._DEVICE,
             th._DEVICE_MIN_BLOCKS)
    if after != routes:
        raise AssertionError(f"[soak] the fault run left the routes {after}, not {routes}")
    return {"seconds": seconds, "raised": f"{type(raised).__name__}: {raised}",
            "hits": hits, "breaker": breaker, "bundle": os.path.basename(bundle)}


def soak_boundary_check(device: str = "cuda") -> float:
    """The next boundary through the routes in force (the card's, after
    [soak]) equals the numpy run, on a 4,096-validator state."""
    import copy

    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.consensus import per_slot
    from lighthouse_tpu_torch.ops import tree_hash as th
    from lighthouse_tpu_torch.types.spec import mainnet_spec
    from lighthouse_tpu_torch.workload import boundary_state

    spec = mainnet_spec()
    base, types = boundary_state(EPOCH_FAULT_VALIDATORS, seed=0xFA0C, leak=False)
    target = base.slot + 1
    enabled = th._ENABLED
    th.configure(enabled=False)
    try:
        mark = boundary_invocations()
        t = time.perf_counter()
        card = per_slot.process_slots(copy.deepcopy(base), target, types, spec).as_ssz_bytes()
        seconds = time.perf_counter() - t
        if boundary_invocations() != mark + 1:
            raise AssertionError("[soak] the boundary after the fault run did not run the fused "
                                 f"program on {device}")
        pe.configure(backend="numpy")
        ref = per_slot.process_slots(copy.deepcopy(base), target, types, spec).as_ssz_bytes()
    finally:
        pe.configure(backend="device", fused_boundary=True, device=device)
        th.configure(enabled=enabled)
    if card != ref:
        raise AssertionError("[soak] the boundary after the fault run != the numpy run")
    return seconds


def phase_soak(card: str, child: CpuChild, device: str = "cuda") -> dict:
    """The soak tooling on the card (see the module docstring)."""
    import shutil
    import tempfile
    from collections import Counter

    from lighthouse_tpu_torch import device_supervisor, metrics
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.crypto.bls import set_backend
    from lighthouse_tpu_torch.ops import cuda_epoch, cuda_sha
    from lighthouse_tpu_torch.ops import tree_hash as th

    tmp = tempfile.mkdtemp(prefix="chip_smoke_soak_card_")
    th.configure(enabled=True, device=device)
    pe.configure(backend="device", fused_boundary=True, device=device)
    try:
        # 1. The soak with its device routes on the card, its objects built
        # on the lock sanitizer's locks.
        fallback = metrics.DEVICE_HOST_FALLBACK.snapshot()
        with recorded_batches() as records, LockSanitizer() as sanitizer:
            cuda_sha.reset_launch_counts()
            cuda_epoch.reset_launch_counts()
            boundaries = boundary_invocations()
            run = soak_run(soak_scenario(), tmp, device)
            launches = {**cuda_sha.LAUNCHES, **cuda_epoch.LAUNCHES,
                        "epoch_boundary": boundary_invocations() - boundaries}
        sanitizer.check()
        edges = sanitizer.locksmith.observed_edges()
        batches = Counter(op for op, _ in records)
        fallen = Counter(op for op, host in records if host)
        if fallen or metrics.DEVICE_HOST_FALLBACK.snapshot() != fallback:
            raise AssertionError(f"[soak] batches took the host route: {dict(fallen)}, "
                                 f"{metrics.DEVICE_HOST_FALLBACK.snapshot()}")
        missing = [k for k in ("sha256_pairs", "shuffle_round", "proposer_walk", "epoch_boundary")
                   if not launches[k]]
        if missing or not batches["sha256_pairs"] or not batches["epoch_boundary"]:
            raise AssertionError(f"[soak] not launched on {device}: {missing} (launches "
                                 f"{launches}); flight records {dict(batches)}")
        for op in ("sha256_pairs", "epoch_boundary"):
            if device_supervisor.breaker_state(op) != "closed":
                raise AssertionError(f"[soak] the {op} breaker is "
                                     f"{device_supervisor.breaker_state(op)}")
        log(f"[soak] {card}: soak_device (smoke_partition's 3 nodes, 16 validators, "
            f"{len(run['timeline'])} window and recovery slots, partition and heal, the fused "
            f"boundary and pair layers of {SOAK_THRESHOLD_BLOCKS}+ blocks on {device}) passed in "
            f"{run['seconds']:.2f} s, finalized epoch {run['finalized']}, head "
            f"{run['head_root'][:16]}; launches {json.dumps(launches)}; flight records "
            f"{json.dumps(dict(batches))}, none on the host")
        log(f"[soak] the run under LIGHTHOUSE_TPU_LOCK_SANITIZE=1: {sanitizer.locks} locks "
            f"built by the sanitizer, {sanitizer.acquisitions} acquisitions checked against "
            f"the static lock graph, {len(edges)} nested lock orders observed {edges}; "
            f"locksmith.check(): 0 violations")

        # 2. A fault on the card, then the routes back.
        set_backend("fake")
        fault = soak_fault(f"{tmp}/fault", device)
        boundary_s = soak_boundary_check(device)
        log(f"[soak] {card}: fused_epoch_boundary on {device} ended at the window's first "
            f"boundary in {fault['seconds']:.2f} s with {fault['raised']!r} (plan hits "
            f"{fault['hits']}, the epoch_boundary breaker {fault['breaker'].get('state')}, "
            f"{fault['breaker'].get('trips_total')} trip), its artifact naming it with bundle "
            f"{fault['bundle']}; the numpy composite never answered; the routes restored, the "
            f"next {EPOCH_FAULT_VALIDATORS}-validator boundary on {device} ({boundary_s:.2f} s) "
            f"equal to the numpy run")

        # 3. The card's run against the CPU reference (the child's runs).
        t = time.perf_counter()
        ref = child.result("reference.json", CHILD_WAIT_S)
        waited = time.perf_counter() - t
        for label in ("soak_cpu", "smoke_host"):
            if (ref[label]["head_root"], ref[label]["timeline"]) != (run["head_root"],
                                                                     run["timeline"]):
                raise AssertionError(f"[soak] the card's run != the CPU reference's {label}: "
                                     f"head {run['head_root'][:16]} vs "
                                     f"{ref[label]['head_root'][:16]}")
        log(f"[soak] {card}: the card's head and per-slot timeline equal to the CPU "
            f"reference's device=\"cpu\" run ({ref['soak_cpu']['seconds']:.1f} s) and "
            f"smoke_partition on the host routes ({ref['smoke_host']['seconds']:.1f} s); the "
            f"child done {ref['wall_s']:.1f} s after its start ({waited:.1f} s waited here)")
    finally:
        child.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        set_backend("torch")
        pe.reset_for_tests()
        th.configure(enabled=False)
    return {"seconds": run["seconds"], "launches": launches, "fault": fault,
            "sanitizer": {"locks": sanitizer.locks, "acquisitions": sanitizer.acquisitions}}


def walk_sweep(seed_words, pivots, k: int, m: int, bound_ms: float) -> dict:
    """proposer_walk at every lookahead on the (S, R) tables, in turns, and
    each lookahead's latency floor: one lane alone, so each of its
    ceil(R / lookahead) steps is one warp's dependent chain of compression
    rounds on an otherwise idle card."""
    from lighthouse_tpu_torch.ops import cuda_epoch

    s, rounds = pivots.shape
    looks = cuda_epoch.WALK_LOOKAHEADS
    walk = in_turns({look: (lambda look=look: cuda_epoch._proposer_walk_k(
        seed_words, pivots, k, m, look)) for look in looks})
    floor = in_turns({look: (lambda look=look: cuda_epoch._proposer_walk_k(
        seed_words[:1].contiguous(), pivots[:1].contiguous(), 1, m, look))
        for look in looks})
    default = cuda_epoch.walk_lookahead()
    log(f"[timing] proposer_walk at {s} x {k} lanes x {rounds} rounds by lookahead: "
        + "; ".join(f"{look}: {walk[look]:.4f} ms, "
                    f"one lane {floor[look]:.4f} ms ({-(-rounds // look)} steps, "
                    f"{floor[look] / -(-rounds // look) * 1e3:.3f} us a step)"
                    for look in looks)
        + f"; the main path's {default} ([autotune]'s measured choice); bound "
        f"{bound_ms:.4f} ms, the main path's {bound_ms / walk[default]:.1%} of it; the "
        f"earlier design "
        f"{EARLIER_MS['proposer_walk']['ms']} ms (PERF.md, not measured here)")
    return {"lookahead": default,
            "ms_by_lookahead": {str(look): v for look, v in walk.items()},
            "floor_ms_by_lookahead": {str(look): v for look, v in floor.items()}}


def phase_epoch_timing(epoch_out: dict, max_err: dict, clock_mhz: float,
                       device: str = "cuda") -> tuple:
    """Each epoch kernel at its largest launch of the [epoch] run (device
    time of graph replays), beside its bound and its plain version; the
    two PyTorch programs (deltas, the fused boundary) at 2^20 the same way,
    the boundary also with the kernels' plain versions, and one boundary
    under torch.profiler for its kernel launches and device busy time.
    Returns (kernel rows, program rows)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.bench_kernels import graph_ms
    from lighthouse_tpu_torch.consensus import per_epoch as pe
    from lighthouse_tpu_torch.ops import cuda_epoch, epoch_device
    from lighthouse_tpu_torch.ops import shuffle_device as psd
    from lighthouse_tpu_torch.profile_verify import trace

    def profiled(run, wall_s: float) -> dict:
        """``trace`` of one ``run()``; a profiler that records no device
        kernel leaves the launch count and busy time not measured."""
        try:
            return trace(run, wall_s)
        except RuntimeError as err:
            log(f"[timing] torch.profiler: {err}; launches and busy time not measured")
            return {"device_kernel_launches": None, "device_busy_s": None, "top_kernels": []}

    ops_per_ms = INT_OPS_PER_CLK_PER_SM * SMS * clock_mhz * 1e3
    dev = torch.device(device)
    t_start = time.perf_counter()
    plan, leak = epoch_out["plans"][0]
    args, nb = psd.boundary_inputs(plan, dev)
    m = plan.m
    (values, sh_pivots, sh_digests, seed_words, prop_pivots) = (args[10], args[11], args[12],
                                                                 args[13], args[14])
    k = psd.PROPOSER_CANDIDATES

    def bound(ops: float, nbytes: float) -> tuple:
        ops_ms, bytes_ms = ops / ops_per_ms, nbytes / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    rows = []
    # shuffle_round: one launch of the 90, at the [epoch] bucket.
    one = (sh_pivots[:1].contiguous(), sh_digests[:1].contiguous())
    ms = graph_ms(lambda: cuda_epoch.shuffle_rounds(values, *one, m))
    plain_ms = graph_ms(lambda: cuda_epoch.shuffle_rounds_plain(values, *one, m), reps=3)
    shuffle_ms = graph_ms(lambda: cuda_epoch.shuffle_rounds(values, sh_pivots, sh_digests, m),
                          reps=3)
    shuffle_plain_ms = graph_ms(
        lambda: cuda_epoch.shuffle_rounds_plain(values, sh_pivots, sh_digests, m),
        reps=1, rounds=2)
    row_bytes = sh_digests.shape[1]
    b_ms, b_by = bound(8 * nb, 8 * nb + row_bytes + 4)
    whole_b_ms, _ = bound(8 * nb * SHUFFLE_ROUNDS, 8 * nb + row_bytes * SHUFFLE_ROUNDS)
    # A two-shard mesh's block: half the lanes of a round, reading the
    # whole list (its lanes and their partners: 8 bytes a lane in, 4 out).
    half = nb // 2
    block_ms = graph_ms(lambda: cuda_epoch.shuffle_rounds(values, *one, m, half, nb - half))
    block_b_ms, _ = bound(8 * half, 12 * half)
    log(f"[timing] shuffle_round's block form, lanes [{half}, {nb}) of {nb}: {block_ms:.4f} ms "
        f"a round, bound {block_b_ms:.4f} ms (bytes), {block_b_ms / block_ms:.1%} of bound")
    log(f"[timing] shuffle_round at {nb} lanes: kernel {ms:.4f} ms a round, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound; the {SHUFFLE_ROUNDS}-round "
        f"shuffle {shuffle_ms:.4f} ms (plain {shuffle_plain_ms:.4f} ms), "
        f"{SHUFFLE_ROUNDS} x the round bound {b_ms * SHUFFLE_ROUNDS:.4f} ms, one-pass bound "
        f"{whole_b_ms:.4f} ms")
    rows.append({"name": "shuffle_round", "route": "cuda", "source": SHUFFLE_SOURCE,
                 "replaces": EPOCH_KERNELS["shuffle_round"]["replaces"],
                 "launches": epoch_out["launches"]["shuffle_round"],
                 "max_abs_err": max_err["shuffle_round"], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rows": nb,
                 "shuffle_ms": shuffle_ms, "shuffle_plain_ms": shuffle_plain_ms,
                 "shuffle_bound_ms": b_ms * SHUFFLE_ROUNDS, "shuffle_one_pass_bound_ms": whole_b_ms,
                 "launches_per_boundary": epoch_out["launches"]["shuffle_round"]
                 / len(epoch_out["plans"]),
                 "block_ms": block_ms, "block_bound_ms": block_b_ms,
                 "sharded": {label: {"launches_by_shard": r["shuffle_round_per_shard"]}
                             for label, r in epoch_out.get("mesh", {}).items()}})
    # proposer_walk: the [epoch] launch (32 slots x 64 candidates x 90 rounds).
    s = seed_words.shape[0]
    ms = graph_ms(lambda: cuda_epoch.proposer_walk(seed_words, prop_pivots, k, m))
    plain_ms = graph_ms(lambda: cuda_epoch.proposer_walk_plain(seed_words, prop_pivots, k, m),
                        **PLAIN_ONCE)
    b_ms, b_by = bound(s * k * SHUFFLE_ROUNDS * WALK_OPS_PER_ROUND + s * WALK_OPS_PER_SLOT,
                       s * 32 + s * SHUFFLE_ROUNDS * 4 + s * k * 4)
    log(f"[timing] proposer_walk at {s} x {k} lanes x {SHUFFLE_ROUNDS} rounds: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; SM clock "
        f"{clock_mhz:.0f} MHz), {b_ms / ms:.1%} of bound ({s * k} lanes cannot fill the card)")
    row = {"name": "proposer_walk", "route": "cuda", "source": SHUFFLE_SOURCE,
           "replaces": EPOCH_KERNELS["proposer_walk"]["replaces"],
           "launches": epoch_out["launches"]["proposer_walk"],
           "max_abs_err": max_err["proposer_walk"], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rows": s * k,
           "launches_per_boundary": epoch_out["launches"]["proposer_walk"]
           / len(epoch_out["plans"])}
    row.update(walk_sweep(seed_words, prop_pivots, k, m, b_ms))
    rows.append(row)
    log(f"[timing] the epoch kernels' rows in {time.perf_counter() - t_start:.1f} s")

    # The PyTorch programs at 2^20.
    programs = {}
    boundary_ms = graph_ms(lambda: psd._boundary_kernel(*args, in_leak=leak), reps=2, rounds=3)
    real = (cuda_epoch.shuffle_rounds, cuda_epoch.proposer_walk)
    cuda_epoch.shuffle_rounds = cuda_epoch.shuffle_rounds_plain
    cuda_epoch.proposer_walk = cuda_epoch.proposer_walk_plain
    try:
        boundary_plain_ms = graph_ms(lambda: psd._boundary_kernel(*args, in_leak=leak),
                                     **PLAIN_ONCE)
    finally:
        cuda_epoch.shuffle_rounds, cuda_epoch.proposer_walk = real
    t = time.perf_counter()
    pe._epoch_boundary_numpy(plan, in_leak=leak)
    boundary_numpy_s = time.perf_counter() - t
    t = time.perf_counter()
    psd._boundary_kernel(*args, in_leak=leak)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    prof = profiled(lambda: (psd._boundary_kernel(*args, in_leak=leak), torch.cuda.synchronize()),
                    wall_s)
    # Bytes: 9 int64 and 1 bool batched inputs, active_idx, the shuffle and
    # walk tables; 3 int64, 3 bool and the int32 shuffling out.
    b_bytes = nb * (9 * 8 + 1 + 4) + sum(int(a.numel() * a.element_size()) for a in args[11:16]) \
        + nb * (3 * 8 + 3 + 4)
    b_ms, b_by = bound(s * k * SHUFFLE_ROUNDS * WALK_OPS_PER_ROUND + s * WALK_OPS_PER_SLOT,
                       b_bytes)
    programs["_boundary_kernel"] = {
        "replaces": "lighthouse_tpu/ops/shuffle_device.py:192", "rows": nb, "ms": boundary_ms,
        "plain_kernels_ms": boundary_plain_ms, "numpy_host_s": boundary_numpy_s,
        "bound_ms": b_ms, "bound_by": b_by, "launches_per_boundary": 1,
        "device_kernel_launches": prof["device_kernel_launches"],
        "device_busy_s": prof["device_busy_s"], "wall_s": wall_s,
        "top_kernels": prof["top_kernels"][:6]}
    log(f"[timing] _boundary_kernel at {nb} validators ({'leak' if leak else 'no leak'}): "
        f"{boundary_ms:.4f} ms (graph replay), with the kernels' plain versions "
        f"{boundary_plain_ms:.4f} ms, numpy composite {boundary_numpy_s:.3f} s on the host; "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / boundary_ms:.1%} of bound; "
        f"{prof['device_kernel_launches']} kernel launches, device busy "
        f"{(prof['device_busy_s'] or 0.0) * 1e3:.3f} ms of a {wall_s * 1e3:.3f} ms eager call; top "
        f"{[(k_['name'][:40], k_['count']) for k_ in prof['top_kernels'][:6]]}")
    arrays, prev_part, inactivity, kwargs = epoch_out["deltas_args"]
    n = arrays.n
    dnb = epoch_device._bucket(n)
    dev_in = [torch.from_numpy(epoch_device.grow_rows(np.asarray(a), dnb, f)).to(dev)
              for a, f in zip((arrays.effective_balance, arrays.activation_epoch,
                               arrays.exit_epoch, arrays.withdrawable_epoch, arrays.slashed,
                               prev_part, inactivity), epoch_device._PAD_FILLS)]
    spec = kwargs["spec"]
    scalars = (kwargs["previous_epoch"], kwargs["base_reward_per_increment"],
               kwargs["total_active_balance"], spec.effective_balance_increment,
               spec.inactivity_score_bias, spec.inactivity_score_recovery_rate, kwargs["quotient"])
    deltas_ms = graph_ms(lambda: epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False),
                         reps=3, rounds=3)
    t = time.perf_counter()
    epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False)
    torch.cuda.synchronize()
    d_wall = time.perf_counter() - t
    dprof = profiled(lambda: (epoch_device._deltas_kernel(*dev_in, *scalars, in_leak=False),
                              torch.cuda.synchronize()), d_wall)
    d_ms, d_by = bound(0, dnb * (6 * 8 + 1 + 2 * 8))
    programs["_deltas_kernel"] = {
        "replaces": "lighthouse_tpu/ops/epoch_device.py:128", "rows": dnb, "ms": deltas_ms,
        "numpy_host_s": epoch_out["deltas_numpy_s"], "bound_ms": d_ms, "bound_by": d_by,
        "launches_per_boundary": 1, "device_kernel_launches": dprof["device_kernel_launches"],
        "device_busy_s": dprof["device_busy_s"], "wall_s": d_wall}
    log(f"[timing] _deltas_kernel at {dnb} validators: {deltas_ms:.4f} ms (graph replay), "
        f"numpy pass {epoch_out['deltas_numpy_s']:.3f} s on the host; bound {d_ms:.4f} ms "
        f"(bytes), {d_ms / deltas_ms:.1%} of bound; {dprof['device_kernel_launches']} kernel "
        f"launches (the fused boundary runs this body too; the staged seam runs it alone)")
    return rows, programs


def phase_timing(cuda_fq, verify_out: dict, kzg_out: dict, block_out: dict, wire_out: dict,
                 net_out: dict, max_err: dict, clock_mhz: float) -> list:
    import torch

    from lighthouse_tpu_torch.bench_kernels import OPS, graph_ms, operands, ops_per_ms, time_library

    lib, _ = cuda_fq.library(torch.device("cuda"))
    # Each launch size is timed once, whichever runs gave it.
    memo = {}
    timed = time_library(lib, verify_out["sizes"], clock_mhz, memo)
    per_kzg = {key: time_library(lib, kzg_out[key]["sizes"], clock_mhz, memo)
               for key in ("kzg6", "kzg192")}
    per_block = time_library(lib, block_out["fq_sizes"], clock_mhz, memo)
    per_drain = {key: time_library(lib, drain["sizes"], clock_mhz, memo)
                 for key, drain in (("wire", wire_out), ("network", net_out))}
    out = []
    for name, spec in KERNELS.items():
        t = timed[name]
        n, ms = t["at_max"]
        a, b = operands(name, n, seed=1)
        plain = getattr(cuda_fq, f"{name}_plain")
        plain_ms = graph_ms(lambda: plain(a, b), reps=3)
        ops_ms = n * OPS[name] / ops_per_ms(clock_mhz)
        bytes_ms = n * spec["bytes"] / HBM_BYTES_PER_S * 1e3
        mean_n, mean_ms = t["at_mean"]
        log(f"[timing] {name} at n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}, "
            f"SM clock {clock_mhz:.0f} MHz), {max(ops_ms, bytes_ms) / ms:.1%} of bound; "
            f"at the mean launch n={mean_n}: {mean_ms:.4f} ms")
        log(f"[timing] {name} per {tag(MAIN)} verify: {t['verify_ms']:.4f} ms over "
            f"{t['launches']} launches of {len(t['ms_by_size'])} sizes, bound "
            f"{t['verify_bound_ms']:.4f} ms ({t['verify_bound_ms'] / t['verify_ms']:.1%})")
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": spec["replaces"],
            "launches": verify_out["launches"][name],
            "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "rows": n, "mean_rows": t["mean_rows"], "mean_ms": mean_ms,
            "verify_ms": t["verify_ms"], "verify_bound_ms": t["verify_bound_ms"],
        }
        for key, label in (("kzg6", f"{KZG_BLOBS}-blob"), ("kzg192", f"{KZG_LANES}-lane")):
            k = per_kzg[key][name]
            log(f"[timing] {name} per {label} KZG batch: {k['verify_ms']:.4f} ms over "
                f"{k['launches']} launches of {len(k['ms_by_size'])} sizes (largest "
                f"{k['at_max'][0]} rows), bound {k['verify_bound_ms']:.4f} ms "
                f"({k['verify_bound_ms'] / k['verify_ms']:.1%})")
            row.update({f"{key}_launches": kzg_out[key]["launches"][name],
                        f"{key}_ms": k["verify_ms"], f"{key}_bound_ms": k["verify_bound_ms"]})
        k = per_block[name]
        log(f"[timing] {name} per block import ({block_out['bucket']} verify batch): "
            f"{k['verify_ms']:.4f} ms over {k['launches']} launches of {len(k['ms_by_size'])} "
            f"sizes (largest {k['at_max'][0]} rows), bound {k['verify_bound_ms']:.4f} ms "
            f"({k['verify_bound_ms'] / k['verify_ms']:.1%})")
        row.update({"block_launches": block_out["launches"][name], "block_ms": k["verify_ms"],
                    "block_bound_ms": k["verify_bound_ms"]})
        for key, drain in (("wire", wire_out), ("network", net_out)):
            k = per_drain[key][name]
            per_batch = {kind: d[name] for (kind, _, _), (_, d) in
                         zip(drain["batches"], drain["dispatch_launches"])}
            log(f"[timing] {name} per [{key}] drain of {drain['batches'][0][1]} gossip "
                f"attestations and {drain['batches'][1][1]} aggregates (batches "
                f"{drain['batches']}, buckets {drain['buckets']}, launches {per_batch}): "
                f"{k['verify_ms']:.4f} ms over {k['launches']} launches of "
                f"{len(k['ms_by_size'])} sizes (largest {k['at_max'][0]} rows), bound "
                f"{k['verify_bound_ms']:.4f} ms ({k['verify_bound_ms'] / k['verify_ms']:.1%})")
            row.update({f"{key}_launches": drain["launches"][name],
                        f"{key}_attestation_launches": per_batch["attestation"],
                        f"{key}_aggregate_launches": per_batch["aggregate"],
                        f"{key}_ms": k["verify_ms"], f"{key}_bound_ms": k["verify_bound_ms"],
                        f"{key}_buckets": drain["buckets"]})
        out.append(row)
    return out


def in_turns(variants: dict, **kw) -> dict:
    """Device ms of each ``variants[name]()`` (graph replay), one after the
    other in one call on one card: {name: ms}.  (Timed twice, forward then
    backward, the two agreed to three significant figures at every size;
    PERF.md.)"""
    from lighthouse_tpu_torch.bench_kernels import graph_ms

    return {name: graph_ms(fn, **kw) for name, fn in variants.items()}


def subtree_sweep(state_out: dict, bound) -> dict:
    """tree_hash_subtrees at every T of the kernel and at the table's
    choice, at each size the [state] run launched (the caller's buckets)
    and the top bucket, in turns; the sum over the [state] run's launches
    at each T."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.ops import cuda_sha

    rng = np.random.default_rng(0x7E)
    sizes = state_out["sizes"]["tree_hash_subtrees"]
    by_t = {t: {} for t in ("table",) + cuda_sha.SUBTREE_THREADS}
    for m in sorted(set(sizes) | {SUBTREE_MS[-1]}):
        y = torch.from_numpy(sha_words(rng, (m, 32, 8)).view(np.int32)).cuda()
        times = in_turns({t: (lambda t=t: cuda_sha._tree_hash_subtrees_t(
            y, None if t == "table" else t)) for t in by_t})
        for t, pair in times.items():
            by_t[t][m] = pair
        chosen = cuda_sha.subtree_threads(m)
        fastest = min(cuda_sha.SUBTREE_THREADS, key=lambda t: times[t])
        earlier = EARLIER_MS["tree_hash_subtrees"]["by_size"].get(m)
        log(f"[timing] tree_hash_subtrees at m={m}: "
            + ", ".join(f"T={t} {p:.4f} ms"
                        for t, p in times.items())
            + f"; the table's T={chosen}, the fastest T={fastest}; bound {bound(m)[0]:.4f} ms, "
            f"the table's {bound(m)[0] / times['table']:.1%} of it; the earlier design "
            + (f"{earlier} ms (PERF.md, not measured here)" if earlier is not None
               else "not recorded"))
    state_sums = {str(t): sum(by_t[t][m] * c for m, c in sizes.items()) for t in by_t}
    log(f"[timing] tree_hash_subtrees over the [state] run's "
        f"{sum(sizes.values())} launches: "
        + ", ".join(f"T={t} {v:.4f} ms" for t, v in state_sums.items())
        + f"; the earlier design {EARLIER_MS['tree_hash_subtrees']['state']} ms (PERF.md, "
        "not measured here)")
    return {"ms_by_threads": {str(t): {str(m): p for m, p in v.items()}
                              for t, v in by_t.items()},
            "state_ms_by_threads": state_sums}


def phase_hash_timing(state_out: dict, block_out: dict, max_err: dict, clock_mhz: float) -> list:
    """Each SHA-256 kernel at its top bucket and at every launch size of the
    [state] run and of the [block] import (device times replayed from a
    CUDA graph), beside its bound and its plain version, and the native
    host kernel's rate."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.bench_kernels import graph_ms
    from lighthouse_tpu_torch.ops import cuda_sha
    from lighthouse_tpu_torch.types import ssz

    ops_per_ms = INT_OPS_PER_CLK_PER_SM * SMS * clock_mhz * 1e3
    rng = np.random.default_rng(0x71)
    inputs = {
        "sha256_pairs": lambda n: torch.from_numpy(sha_words(rng, (n, 16)).view(np.int32)).cuda(),
        "tree_hash_subtrees": lambda n: torch.from_numpy(
            sha_words(rng, (n, 32, 8)).view(np.int32)).cuda(),
    }
    top = {"sha256_pairs": PAIR_NS[-1], "tree_hash_subtrees": SUBTREE_MS[-1]}

    def bound(name: str, n: int) -> tuple:
        spec = SHA_KERNELS[name]
        ops_ms = n * spec["ops"] / ops_per_ms
        bytes_ms = n * spec["bytes"] / HBM_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    # The host kernel the routing thresholds weigh the card against.
    blocks = top["sha256_pairs"]
    data = rng.integers(0, 256, blocks * 64, dtype=np.uint8).tobytes()
    ssz._hash_pairs(data)
    t0 = time.perf_counter()
    ssz._hash_pairs(data)
    host_rate = blocks / (time.perf_counter() - t0)
    log(f"[timing] native host pair hasher ({ssz._hash_pairs.__name__}): "
        f"{host_rate:.0f} blocks/s on {blocks} blocks")

    out = []
    roots = len(state_out["roots"])
    for name, spec in SHA_KERNELS.items():
        wrapper = getattr(cuda_sha, name)
        plain = getattr(cuda_sha, f"{name}_plain")
        n = top[name]
        x = inputs[name](n)
        ms = graph_ms(lambda: wrapper(x))
        plain_ms = graph_ms(lambda: plain(x), **PLAIN_ONCE)
        bound_ms, bound_by = bound(name, n)
        sizes = state_out["sizes"][name]
        by_size, plain_by_size = {}, {}
        for m in sorted(sizes):
            y = inputs[name](m)
            got, want = wrapper(y), plain(y)
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"{name} at the [state] size {m}: kernel != plain")
            by_size[m] = graph_ms(lambda: wrapper(y))
            plain_by_size[m] = graph_ms(lambda: plain(y), **PLAIN_ONCE)
        block_sizes = block_out["sha_sizes"][name]
        block_by_size = {m: by_size[m] for m in block_sizes if m in by_size}
        for m in sorted(set(block_sizes) - set(block_by_size)):
            y = inputs[name](m)
            got, want = wrapper(y), plain(y)
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"{name} at the [block] size {m}: kernel != plain")
            block_by_size[m] = graph_ms(lambda: wrapper(y))
        block_ms = sum(block_by_size[m] * c for m, c in block_sizes.items())
        block_bound_ms = sum(bound(name, m)[0] * c for m, c in block_sizes.items())
        state_ms = sum(by_size[m] * c for m, c in sizes.items())
        state_plain_ms = sum(plain_by_size[m] * c for m, c in sizes.items())
        state_bound_ms = sum(bound(name, m)[0] * c for m, c in sizes.items())
        launches = state_out["launches"][name]
        log(f"[timing] {name} at its top bucket n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; SM clock {clock_mhz:.0f} MHz), "
            f"{bound_ms / ms:.1%} of bound")
        log(f"[timing] {name} over the [state] run's {launches} launches ({roots} roots, "
            f"{launches / roots:.1f} a root; sizes {dict(sorted(sizes.items()))}): "
            f"{state_ms:.4f} ms, bound {state_bound_ms:.4f} ms "
            f"({state_bound_ms / state_ms:.1%}), plain {state_plain_ms:.4f} ms; equal to the "
            f"plain version at each size; per size kernel "
            f"{ {m: round(t, 4) for m, t in by_size.items()} }, plain "
            f"{ {m: round(t, 4) for m, t in plain_by_size.items()} }")
        log(f"[timing] {name} per block import: {block_ms:.4f} ms over "
            f"{block_out['launches'][name]} launches (sizes {dict(sorted(block_sizes.items()))}), "
            f"bound {block_bound_ms:.4f} ms ({block_bound_ms / block_ms:.1%}); per size "
            f"{ {m: round(t, 4) for m, t in sorted(block_by_size.items())} }")
        row = {
            "name": name, "route": "cuda", "source": SHA_SOURCE,
            "replaces": spec["replaces"],
            "launches": launches,
            "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "rows": n, "state_ms": state_ms, "state_bound_ms": state_bound_ms,
            "state_plain_ms": state_plain_ms,
            "state_sizes": {str(m): c for m, c in sorted(sizes.items())},
            "launches_per_root": launches / roots,
            "host_blocks_per_s": host_rate,
            "block_launches": block_out["launches"][name], "block_ms": block_ms,
            "block_bound_ms": block_bound_ms,
        }
        if name == "tree_hash_subtrees":
            row.update(subtree_sweep(state_out, lambda m: bound(name, m)))
            row["threads"] = cuda_sha.subtree_threads(n)
        out.append(row)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    from lighthouse_tpu_torch.ops import cuda_fq

    t_start = time.perf_counter()
    child = CpuChild()  # the KZG inputs and [soak]'s CPU reference, beside the card phases
    card = nvidia_smi("name,power.limit")
    log(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] {torch.cuda.get_device_name(0)}, max SM clock {clock_mhz:.0f} MHz, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    with phase_wall("build"):
        phase_build()
    with phase_wall("kernels"):
        max_err = phase_kernels(cuda_fq)
    with phase_wall("hash-kernels"):
        max_err.update(phase_hash_kernels())
    with phase_wall("epoch-kernels"):
        max_err.update(phase_epoch_kernels())
    with phase_wall("verify"):
        verify_out = phase_verify(cuda_fq)
    with phase_wall("parity"):
        phase_parity()
    with phase_wall("kzg"):
        kzg_in = kzg_inputs(child)
        lanes = blob_lanes(*kzg_in)
        kzg_out = phase_kzg(cuda_fq, *kzg_in, lanes)
    with phase_wall("kzg-parity"):
        phase_kzg_parity(lanes)
    with phase_wall("runtime"):
        runtime_out = phase_runtime(cuda_fq, card, *kzg_in)
    with phase_wall("hash-runtime"):
        phase_hash_runtime(card)
    with phase_wall("mesh"):
        phase_mesh(card, cuda_fq, verify_out.pop("sets"), *kzg_in)
    with phase_wall("autotune"):
        phase_autotune(card)
    with phase_wall("state"):
        state_out = phase_state(card)
    with phase_wall("epoch"):
        epoch_out = phase_epoch(card)
        epoch_out["mesh"] = phase_epoch_mesh(card, epoch_out)
    # [block] and [chain] share one case whose block carries the six KZG
    # commitments; [block] applies the block to its pre-state in place, so
    # [chain]'s anchor is a copy taken before (after [block]'s warm root),
    # and [block]'s states go before [chain] builds its node.
    with phase_wall("block"):
        case, build_s = block_case(commitments=kzg_in[2])
        block_out = phase_block(card, case=case, build_s=build_s)
        anchor = block_out.pop("anchor")
        case = case._replace(pre_state=None)
        gc.collect()
    with phase_wall("chain"):
        chain_out = phase_chain(card, case, anchor, kzg_in)
        del case, anchor
        gc.collect()
    with phase_wall("chain-harness"):
        phase_chain_harness(card)
    with phase_wall("soak"):
        soak_out = phase_soak(card, child)
    with phase_wall("faults"):
        phase_faults(cuda_fq, *kzg_in)
    with phase_wall("timing"):
        parts = [time.perf_counter()]
        kernels = phase_timing(cuda_fq, verify_out, kzg_out, block_out, chain_out["wire"],
                               chain_out["network"], max_err, clock_mhz)
        for row in kernels:
            row["runtime_launches"] = runtime_out["launches"][row["name"]]
        parts.append(time.perf_counter())
        kernels += phase_hash_timing(state_out, block_out, max_err, clock_mhz)
        parts.append(time.perf_counter())
        epoch_rows, programs = phase_epoch_timing(epoch_out, max_err, clock_mhz)
        kernels += epoch_rows
        for row in kernels:  # [soak]'s launches (0: fake crypto, or below the thresholds)
            row["soak_launches"] = soak_out["launches"].get(row["name"], 0)
        parts.append(time.perf_counter())
        log(f"[timing] epoch programs {json.dumps(programs)}")
        log(f"[timing] the Fq kernels {parts[1] - parts[0]:.1f} s, the SHA-256 kernels "
            f"{parts[2] - parts[1]:.1f} s, the epoch kernels and programs "
            f"{parts[3] - parts[2]:.1f} s")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
