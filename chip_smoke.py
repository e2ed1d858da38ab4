#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (semadb_tpu_torch) starts and is
right on one NVIDIA GPU.

Usage, from the root of a checkout (one CUDA card, no network):

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run (non-zero exit, no result line):

1. Environment and build: the card (``nvidia-smi``), torch and CUDA versions,
   the codecs, then K1 (``semadb_tpu_torch/csrc/hamming.cu``), K2
   (``csrc/gather.cu``), K3 (``csrc/ivf_scan.cu``), K4
   (``csrc/ivf_rerank.cu``), K5 (``csrc/ivf_probe_topk.cu``), K9 (``csrc/ivf_pq_scan.cu``), K10
   (``csrc/vamana_search.cu``) and K11 (``csrc/vamana_prune.cu``) built with
   ``nvcc`` and the key-value store (``csrc/kvstore.cpp``) with ``g++`` from
   the checkout's sources, all nine at once, timed.
2. Kernel: K1 against its plain PyTorch version on the card, hamming and
   jaccard, on both of its routes (tensor cores and CUDA cores), at B in
   {1, 2, 7, 8, 15, 16, 17, 33, 64, 1000} (both sides of the route
   threshold), N in {1, 511, 100003}, W in {1, 5, 8, 9, 48, 128}, and at
   B = 4096 over N = 32,768, W = 48 and B = 65,537 (two launches) over
   N = 511, W = 5. Both metrics must be exactly equal (integer counts and
   one IEEE f32 division on both sides).
3. The slice (``semadb_tpu_torch/tools/dbpedia_bq.py``): the port's
   ClusterNode and HTTP v2 server, in-process on ``cuda``, with
   ``config/singleServer.yaml`` (the root dir a temporary directory; the
   RPC and HTTP ports 0, i.e. ephemeral). A 1536-d cosine ``vectorFlat``
   collection with a binary quantizer (hamming, threshold 0.0) — the
   reference's dbpedia-openai-100k-angular v2-BQ deployment — takes
   100,000 points: 1,000 over HTTP and the rest through
   ``ClusterNode.insert_points`` (the call the v2 insert handler makes) in
   batches of 10,000. Then 10 single searches and one batch of 64 over
   HTTP; every result is checked against a numpy brute-force hamming scan
   over the sign bits by the tie rule. K1's launch counts are zeroed
   before this phase; after it there must be launches at B = 1 and at
   B > 1, and on each route.
4. Kernel timing at the slice's shapes: B = 1, 64 and 4096 over the
   largest shard's own code table (W = 48), the queries being
   ``dbpedia_bq.queries`` encoded with the shard's threshold. K1 must
   first equal its plain version on these operands, both metrics, both
   routes, exactly (at B = 4096 the plain version is compared, not timed).
   Then each route's device time per call (torch.profiler over 30 calls,
   K1's own events) twice: warm, back to back, and L2-cold, with 128 MB
   written and another 128 MB read between calls (the read leaves clean
   lines, so the kernel pays no write-back of the flush); the cold time is
   the one set against the bound. Also the plain version's device time
   and a call's time with its host launch work (median of 30, CUDA
   events) at B = 1 and 64, and both routes cold at B in {2, 4, 8, 16, 32},
   where the route threshold lies.
5. K2 kernel: the gather against its plain PyTorch version on the card,
   exactly (``torch.equal``), through the checked path, at D in {1, 3, 128,
   1536}, n in {1, 1023, 1024, 100003}, cap in {1, 70001}, ids holding 0,
   cap - 1 and repeats; once more with a base pointer off the 16-byte grid.
   ``gather_rows`` must refuse n % 1024 != 0 and the checked path ids of
   cap and -1.
6. The gather path: ``semadb_tpu_torch.tools.gatherbench.main`` at its
   defaults on ``cuda`` (1,000,000 x 128 f32 vectors, 1,048,576 ids): K2,
   ``torch.index_select`` and the plain version timed; the whole kernel
   output must equal ``index_select``'s. K2's launch count is zeroed before
   this phase and must be > 0 after it.

7. K3 and K4 (``csrc/ivf_scan.cu``, ``csrc/ivf_rerank.cu``, the IVF query's
   probed-slab scan and exact rerank) against their plain PyTorch versions on
   the card: K3 at B in {1, 7, 64, 4096}, p in {1, 5, 24, 96}, S in {64, 128, 192}, r in {3,
   100, 128}, rr in {20, 64, 256}, f32 and bf16 slabs, 30% NIL slots, with
   and without a filter mask (every value of each parameter, in 20
   combinations), the bench cell's shape, the fused cell's (S = 256, r = 194,
   bf16), and the layouts a batch meets:
   every query on the same 24 probes (B = 4096, the load imbalance), ids
   stored in two clusters, live prefixes with holes (a refit's packing, then
   deletes), and a scratch budget patched small so that B runs in chunks;
   K4 at D in {3, 128, 1536}, k in {1, 10, 100}, all three metrics (27
   combinations), pools that hold ids two or three times, deduplicated by
   the kernel (9 more), and both routes of its design (bulk copies at D in
   {4, 128, 1536, 4096}; element loads at D = 3 and on a base off the
   16-byte grid) across k in {1, 10, 32, 33, 100}, rr in {20, 64, 256,
   2048} and B in {1, 7, 4096}, pools with every id 2-3 times and a pool
   that is all empty (33 more), and the fused cell's D = 194 (the element
   route). K9 (``csrc/ivf_pq_scan.cu``, the ADC scan of PQ codes): its probed
   entry at B in {1, 7, 64, 4096}, p in {1, 24, 96}, S in {64, 128, 256}, M
   in {2, 4, 8, 16, 128}, K in {16, 256}, rr in {20, 256, 2048}, 30% NIL
   slots, with and without a mask (every value, in 14 combinations, the
   IVF-PQ cell's shape among them), and at 12 layouts that stress its
   selection (a cluster probed twice with probes of -1 and C, tie-heavy
   integer tables at K = 16, M = 2, negative tables, clusters with no live
   slot, no live slot at all, rr above the live slots up to rr = 2048 at
   B = 4096, and the chunk patched small so that a query takes several
   selections), scores within 1e-5 of M · max|table|, pools by the tie rule,
   exactly min(rr, live) places filled; 51 calls at the IVF-PQ cell's shape
   on normal tables must give one result bit for bit; its dense entry at N in {1, 4096, 100,003} with
   masked rows, the same tolerance. K3 also at the 10M cell's widths over one
   slab set made on the card: C = 131,072 (32 tiles of the offsets scan),
   S = 192, r = 128, bf16, 30% NIL slots, at B in {1, 4096} x p in {24, 96},
   with and without a mask. Distances must agree within 1e-5 of the
   summed terms' magnitude (the sums run in another order), ids by the tie
   rule at that tolerance, pools as multisets. K5 (``csrc/ivf_probe_topk.cu``,
   probe selection) against a float64 reference at six shapes (``K5_CHECKS``:
   B from 1 to 4,096, C up to 131,072, D in {100, 128, 194}, p in {24, 96,
   256}, both metrics), ids by the tie rule at that tolerance, then timed
   beside its plain version at the bench cell's shape, B = 1 and C = 131,072.
8. The IVF bench cell: ``semadb_tpu_torch.tools.annbench.main`` at its
   defaults on ``cuda`` (the JAX package's default ``python bench.py``:
   1,000,000 x 128 ``embedding_like(spread=0.5, seed=42)``, euclidean,
   assignCopies 2, 32,768 queries in batches of 4,096, k = 10): recall@10
   against the exact f32 ground truth must be >= 0.99 and K3 and K4 must
   have launched; it prints the build's split, QPS, peak device memory and
   a torch.profiler pass over one batch, stage by stage. Then K3 and K4 on
   the cell's own operands (4,096 queries): checked against their plain
   versions, timed (torch.profiler, mean of 20 calls; K3's time is every
   device event of its calls, its five kernels and its memset, each with one
   launch a call, or at least half of them where the profiler lost launches
   (P2), and it must lie within 75-100% of the CUDA-event time of the same
   calls in the same window; a window that fails either is opened again,
   and after three the CUDA-event time is reported instead, logged; the same
   holds for K3 at the 10M and fused cells and for every other kernel time:
   a lost profiler window never fails the run), the plain
   versions timed, and set
   against their byte bounds; K3 also at B from 1 to 4,096 (the cell's first
   B queries), K4 also at B = 1, on the device and as a call with its host
   work. Then K4 at the projected traversal's shape (D = 1536, rr = 256,
   k = 10, B = 4,096 and 1) over a seeded f32[400,000, 1536] table and random
   pools: checked, timed, its bound from the distinct rows the pools hold.
   With ``--k4-baseline SOURCE`` (another K4 source with the same C
   interface, such as the parent commit's) that library is built and timed
   beside the tree's K4 at each of these shapes.
8b. ``vectorIVF`` over HTTP v2: the port's node and server with
   ``config/singleServer.yaml``, a 128-d euclidean ``vectorIVF`` collection
   of 20,000 points (``embedding_like``, the bench cell's generator and
   spread) inserted through ``ClusterNode.insert_points``, 10 HTTP searches
   with held-out queries checked against numpy brute force (recall@10 >=
   0.95, every returned distance exact); K3 and K4 must have launched in
   this phase.
9. A hybrid collection over HTTP v2, as in 8b, on one shard
   (``shardPlacement: device``): a 128-d ``vectorIVF`` property beside
   ``body`` (text), ``category`` (string), ``year`` (integer) and ``tags``
   (stringArray), 100,000 documents (the reference text bench's corpus, Zipf
   over 20,000 words) ingested 10,000 a write transaction. Every query is
   checked against a plain evaluation over the generated documents: string,
   integer and stringArray filters (the first page over HTTP, and the whole
   set as the shard's index manager finds it);
   ``vectorIVF`` filtered by each (numpy's brute force over the members, the
   tie rule, distances exact); text ``containsAny`` and ``containsAll`` over
   common and mid-rank terms (the TF-IDF formula recomputed in numpy; scores
   within 1e-5 relative, descending, ids by the tie rule); a hybrid ``_or``
   of an unfiltered ``vectorIVF`` arm and a text arm (each hybrid score the
   arms' weighted sum; K3 and K4 must have launched). Then the widened-probe
   path on phase 8's index: a random filter over half its 1,000,000 points
   (past ``FILTER_EXACT_CAP``, so p = 4 x 24 and K3 skips masked slots),
   256 queries, recall@10 against numpy's exact search over the members
   >= 0.95, K3 and K4 launched. Then phase 8's index is dropped.
10. The 10M cell: ``BENCH_N=10000000 python bench.py`` on the port,
   ``annbench.main(["--n", "10000000", "--sweep", "48,96"])``: 10,000,000 x
   128 from ``embedding_like_device(spread=0.5, seed=42)`` on the card,
   euclidean, assignCopies 2, 32,768 queries in batches of 4,096, k = 10,
   the engine's default probes (24), exact f32 ground truth on the card. The
   refit must take the two-level path with the C, S and slab type the code
   predicts (131,072, 192, bf16); recall@10 >= 0.97 (the JAX package read
   0.9790 here); K3 and K4 must have launched; the sweep rows at p = 48 and
   96 are printed, and the build's split, QPS, memory and one batch under
   torch.profiler. Then K3 and K4 on the cell's own operands (checked,
   timed, their byte bounds), K3 and the recall on f32 slabs rebuilt from
   the same ``slab_ids`` (the slab memory budgets' evidence), and two write
   transactions of 10,000 new points each (ids past the corpus: the cell's
   last 10,000 queries, held-out rows of the corpus's mixture, then rows the
   generator draws seeded 43) through ``insert_update_delete``: each
   placement must go through the two-level assignment without a refit, and
   every new point must come back as its own nearest neighbour; the
   assignment's and the write repair's seconds and the rows the repair
   moved are printed.

11. The IVF-PQ cell: ``BENCH_MODE=ivfpq python bench.py`` on the port,
   ``annbench.main(["--quantizer", "product"])``: phase 8's corpus and
   engine with a product quantizer of 8 subvectors x 256 centroids fit at
   10,000 points. Recall@10 >= 0.95; K9 and K4 must have launched and K3 not
   (the f32 slabs are placeholders); the build's split with the PQ fit and
   encode, QPS and one batch under torch.profiler. Then K9 (and K4) on the
   cell's own operands: checked, timed, their byte bounds; K9 at B = 1, and
   its dense entry at the batch's tables over 4,096 rows of the cell's own
   codes (the overflow pool's floor; the cell's pool itself is empty). With
   ``--k9-baseline SOURCE`` (another K9 source with the same C interface,
   such as the parent commit's) that library is built, checked on the cell's
   operands and timed beside the tree's K9 at B = 4,096 and 1, in turns.
12. The fused cell: ``BENCH_MODE=fused python bench.py`` on the port,
   ``annbench.main(["--fused"])``: 1,000,000 points of two views (128 and
   64, ``embedding_like_views(seed=42)``), euclidean, weights 0.7 and 0.3,
   assignCopies 4, 32,768 queries in batches of 4,096. The engine must take
   the shapes the code predicts (194 columns, no projection, S = 256, bf16
   slabs, K4's element route); recall@10 against the exact combined-score
   ground truth >= 0.97; K3 and K4 must have launched. Then K3 and K4 on the
   cell's operands, checked and timed.
13. HTTP v2 with a product quantizer and a fused property: one collection
   (one shard) with a 128-d ``vectorIVF`` and a ``vectorFlat``, each with a
   product quantizer (8 x 256, fit at 10,000 points), and a ``vectorFused``
   property (128 + 64), 20,000 points from ``embedding_like_views``.
   Ten searches of each kind over HTTP: IVF-PQ and fused results against
   numpy's exact search (recall@10 >= 0.9, every returned distance exact
   within 1e-4 relative), flat PQ against the ADC distances numpy computes
   from the shard's own codes and codebooks (the tie rule, within 1e-4
   relative). K9's two entries, K3 and K4 must have launched; K9's dense
   entry is timed at the flat index's shape.

14. K10 (the Vamana beam search, ``csrc/vamana_search.cu``) and K11 (the
   robust prune, ``csrc/vamana_prune.cu``) against their plain PyTorch
   versions on the card, on integer-valued graphs and pools (every
   coordinate an integer in [-8, 8], so every distance is exact in f32),
   every output bit for bit: K10's candidate lists, visited rings, hops and
   counts at L in {1, 25, 40, 75, 100, 129, 512}, W in {1, 2, 8}, R in {32,
   64, 129}, B in {1, 5, 7, 9, 17, 33, 512, 1024, 1025, 4096, 4097, 8192},
   with and without seeds and the ring, a graph of mostly NIL-padded rows, a
   graph of one point, graphs with rows at distance inf and with D = 37 (off
   the 16-byte grid), all four metrics (15 cases, and 10 at the boundaries
   of the second design's geometry: one warp or a block a query, 4 or 8
   warps, a batch no multiple of the queries a block), and 51 repeated calls
   at the query, pass-1 and pass-2 shapes; K11's rows at B in {1, 7, 9, 512,
   4096}, P in {33, 128, 160, 224, 1500, 2048}, R in {32, 64}, all four
   metrics, D in {2, 128, 131, 1536} (pools staged in shared memory and
   pools read from device memory, by 16-byte and by element loads), alpha
   1.0 and 1.2 (24 cases), and 51 repeated calls at pass 2's shape. On real-valued data: K10's top-10 by the tie
   rule within 1e-5 of the terms' magnitude and recall@10 within 0.002 of
   the plain version's (B = 2,048 over 100,000 points, euclidean and
   cosine); K11 at least 99% of the rows equal (a decision at a near-tie may
   part).
15. The Vamana cell: ``BENCH_MODE=plain python bench.py`` on the port,
   ``annbench.main(["--engine", "vamana"])``: 1,000,000 x 128
   ``embedding_like(spread=0.5, seed=42)``, euclidean, the graph at
   searchSize 75, degreeBound 64, alpha 1.2 built by the two-pass
   ``insert_bulk``, 32,768 queries in batches of 8,192 at L = 40, W = 2,
   k = 10. Recall@10 against the exact f32 ground truth must be >= 0.98
   (the JAX package read 0.9989); K10 and K11 must have launched; it prints
   the build's seconds by pass and overflow rounds, QPS (best of 3), hops a
   query, peak memory and one batch under torch.profiler, and K10's and
   K11's launches split by shape (pass 1, pass 2, overflow rounds, queries:
   the build's own counts). Then K10 on the cell's first batch (its entry
   seeds), at pass 1's walk (B = 512, L = 75, W = 8) and at pass 2's
   (B = 4,096), and K11 on pools the insert makes from the cell's graph at
   pass 2's shape (B = 4,096, P = 224), pass 1's (B = 512, P = 160) and one
   overflow round's (the first OVERFLOW_CHUNK targets whose rows the
   backedges of 4,096 of the graph's own rows overflow, P = R + k_in):
   checked against the plain versions as in phase 14, timed (profiler,
   mean of 10 calls, the CUDA-event fallback of P2), the plain versions
   timed, the bounds from each distinct row the walks score and each
   distinct live pool row. With ``--vamana-baseline DIR`` (a directory
   holding another ``vamana_search.cu``, ``vamana_prune.cu`` and
   ``vamana_common.cuh`` with the same C interfaces, such as the parent
   commit's ``semadb_tpu_torch/csrc``) those libraries are built, checked on
   the same operands and timed beside the tree's K10 and K11 at each of
   those shapes, in turns: baseline, tree, tree, baseline.
16. v1 and v2 over HTTP with ``config/singleServer.yaml``, one shard each: a
   v1 collection (vectorSize 128, euclidean) and a v2 ``vectorVamana``
   collection with a ``string`` property, 20,000 ``embedding_like`` points
   each (1,000 over HTTP, the rest through ``ClusterNode.insert_points``).
   Ten single searches of each, a batch of ten and ten filtered searches
   (v2): every distance numpy's within 1e-5 relative, recall@10 >= 0.95.
   Then 500 deletes and 500 updates a collection over HTTP: no deleted
   id may come back, the same checks hold, 20 updated points find
   themselves. Then a flush (the dirty-row snapshot), close and reopen: every
   search must answer the same. K10 and K11 must have launched.
17. K10's bit and ADC routes (``csrc/vamana_search.cu``, the quantized
   walk) against their plain versions: 26 cases on integer operands (the
   signs of an integer graph's vectors packed, D in {40, 100, 128, 200},
   hamming and jaccard with some all-zero codes; random PQ codes through
   integer-valued tables, M in {4, 8, 12, 16, 32, 96}, K in {16, 256}, the
   96 KB tables read through L2), at the cells' walk (B = 8,192, L = 75,
   W = 2, 16 seeds, the ring) and the geometry's boundaries, with and
   without seeds and the ring, every output bit for bit, and 51 repeats at
   the two cells' walks; on real-valued tables (M = 8 and 96, B = 2,048)
   the list distances within 1e-6 of the summed terms.
18-19. The BQ and PQ Vamana cells (``BENCH_MODE=bq`` and ``pq``):
   ``annbench.main(["--engine", "vamana", "--quantizer", "binary" or
   "product"])``, the cell of phase 15 with a binary quantizer (hamming,
   fit at 10,000 points) or a product quantizer (M = 8, K = 256, OPQ, fit at
   10,000 points), queries at L = 75 reranked in f32. Recall@10 must be >=
   0.92 (BQ; the JAX package read 0.9366) and >= 0.94 (PQ; 0.9615); K10's
   route, K4 and K11 must have launched. Then K10's route on the cell's first
   batch (checked against the plain version, timed, its bound from the
   distinct code and adjacency rows) and K4 at the rerank of that walk (B =
   8,192, rr = 225, k = 10, D = 128).
20. The pool build: ``annbench.main(["--engine", "vamana", "--build",
   "pool", "--search-size", "75"])`` on the same corpus: recall@10 >= 0.97
   at L = 75 and >= 0.95 at L = 40 on the same build, its seconds by stage
   and the peak device memory.
21. Three quantized v2 ``vectorVamana`` collections over HTTP with
   ``config/singleServer.yaml``, one shard each, 20,000 points each: a
   binary quantizer (hamming), a product quantizer (8 x 256) and the
   hamming metric on 0/1 vectors. Fifty searches and fifty filtered of each
   against numpy (BQ and PQ distances f32 within 1e-5 relative, unfiltered
   recall@10 >= 0.9; hamming bit counts exact; every filter kept), 500
   deletes and 500 updates a
   collection (no deleted id back, 20 updated points each find themselves
   at distance 0), a flush, close and reopen (every search the same). K10's
   bit and ADC routes and K4 must have launched.
22. The mesh fan-out (``shardPlacement: "device"``, ``parallel/fanout.py``
   and ``cluster/meshsearch.py``). First ``tools/restackbench.py --n
   1000000 --shards 8`` (an ``embedding_like`` fleet, 8 slots on the card):
   full against incremental restack seconds; then one mesh batch of 4,096
   queries, k = 10, the shards' default probes, which must launch K3 and K4
   on every slot and equal the host fan-out over the same shards (each
   shard's own search, merged on the host) by the tie rule; the mesh batch's
   wall time and QPS beside the host fan-out's, and the merge's device time.
   Then a node with an 8-slot mesh on the card and four ``shardPlacement:
   "device"`` v2 collections of 20,000 points over HTTP (vectorIVF,
   vectorVamana, vectorFused, IVF-PQ; 8 shards each): 20 searches each,
   every one served by the mesh (a fall-back to the host fan-out fails the
   phase), K3/K4, K10 and K9 launched, the answers held against the host
   fan-out over the same shards (the tie rule; the Vamana ids' overlap) and
   numpy's recall; HTTP p50 with the mesh and without; a filtered search
   on each f32 kind; a write and a search on the incremental restack.
23. The three-node cluster: the JAX system's ``config/serverA.yaml``,
   ``serverB.yaml`` and ``serverC.yaml`` as three node processes of the port
   on the card (``python -m semadb_tpu_torch.tools.run_cluster``; only the
   root directories rewritten, into a temporary one, and a port only where
   another process holds it). Through A, the slice's BQ collection of
   phase 3 (100,000 x 1536) over HTTP msgpack, whose shards must lie on at
   least two nodes; through B two 20,000 x 128 ``embedding_like``
   collections, a ``vectorIVF`` and a ``vectorVamana`` at its defaults,
   filled through C. Through each node: 10 BQ single searches and a batch
   of 64, each equal to numpy brute force by the tie rule; 10 IVF and 10
   Vamana searches, recall@10 >= 0.95, every distance numpy's within 1e-5
   relative, the same ids from all three. Then 8 client threads for 20 s,
   each request to a node drawn at random: single searches of the three
   collections and insert txns of 20 points into IVF and Vamana; no request
   may fail, and every acknowledged point must then come back through every
   node as its own nearest neighbour at distance 0. The nodes log their
   kernel launches at shutdown: K1, K3, K4, K10 and K11 must each have
   launched. Then the membership change: A alone (its servers list cut to
   itself) fills a 20,000-point ``vectorIVF`` collection (more, up to 5,
   until one shard hashes to another node), A, B and C start with the
   published lists (B and C first), and A's startup sync must ship exactly
   the shards whose rendezvous owner is B or C; every node must answer as A
   did before the move. Last, in this process, a ``ShardManager`` on the card
   over the directories of the node holding most BQ shards, its
   ``max_cache_size`` half of their indices' bytes: every shard searched
   twice, round robin; the budget must evict, and every answer equal an
   unbudgeted load's. ``--cluster-only`` runs phases 1 and 23 alone.
24. The bench workloads (run right after phase 9, whose index its
   ``filtered`` mode searches): the port's ``semadb_tpu_torch.bench`` modes
   on the card at the root ``bench.py``'s defaults, each with its launch
   counts zeroed first. ``shardwrite`` at 1,000,000 x 128 (64 timed txns of
   1,000 points after one warmup txn): all 65 journaled txns replayed by the
   crash reopen, every acknowledged point found at distance 0 under its own
   node id, top-10 overlap of the 64 probes >= 0.95. ``filtered`` at 0.5%
   and 10% of 1M: recall@10 >= 0.999. ``write``, 100 txns of 1,000 points:
   recall@10 >= 0.99 after the writes. ``hybrid`` 128 + 64 at 1M: recall@10
   >= 0.97, and K3 and K4 at its shapes (k = 256, p = 48, rr = 512) held
   against their plain versions. ``http`` at 100,000 x 128 (a depth cut:
   the ingest over loopback is host-bound): recall@10 >= 0.95, every distance
   within 1e-5 relative. The projected IVF at 1,000,000 x 1536
   (``annbench --dim 1536``, data made on the card): recall@10 >= 0.99, K3
   and K4 checked and timed on the cell's own operands. Every mode but
   ``filtered`` (both of its filters take the exact member scan at 1M) must
   launch K3 and K4. ``--bench-only`` runs phases 1 and 24 alone.

Each kernel's bound is its bytes (each input read once, each output
written once; for K2 each distinct row once; for K3 each distinct probed
cluster once, for K4 each distinct live pool row once; for K10 each
distinct row the batch's walks score and each distinct adjacency row they
read once, a code row's bytes in place of a row's on its quantized routes;
for K11 each distinct live candidate's row once; for K9 each query's
table once, each distinct probed cluster's ids once and the codes of its
live slots once) over 3.35 TB/s, from this run's inputs. K2 does no arithmetic. K1's work is bit operations, and the
card's data sheet gives no rate for the tensor cores' single-bit MMA, so
no operations term can be a least time for it; the term at the int8 rate
(2 B N 32W / 1.979e15 s) is printed beside the bound for information.

The data are unit-norm 1536-d vectors with an embedding-like spectrum,
made from ``--seed`` with numpy. Each phase logs a line when it starts and
one when it passed. Output: progress lines, then the card's name and power
limit, a ``{"kernels": [...]}`` JSON line, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNEL_SHAPES = [
    (b, n, w)
    for b in (1, 2, 7, 8, 15, 16, 17, 33, 64, 1000)
    for n in (1, 511, 100003)
    for w in (1, 5, 8, 9, 48, 128)
] + [(4096, 32768, 48), (65537, 511, 5)]
TIMED_B = (1, 64, 4096)
THRESHOLD_B = (2, 4, 8, 16, 32)
LIMIT = 10
GATHER_SHAPES = [(d, n, cap) for d in (1, 3, 128, 1536) for n in (1, 1023, 1024, 100003) for cap in (1, 70001)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15  # H100 SXM tensor cores, int8 dense
FLUSH_BYTES = 128 << 20  # written, and as much read, between L2-cold calls
PROFILER_WINDOWS = 3  # windows a time may take before the CUDA-event time stands in
# Least share of the CUDA-event time of the same calls that K3's profiler
# time may read (the gaps between its kernels are the rest)
K3_EVENT_SHARE = 0.75
# Clock cycles (~0.5 ms on the H100) a timed call may take the host to queue
# under the profiler: the spin that holds the device while the calls are
# queued lasts this much a call (K3 at B = 1 took ~0.11 ms a call of the host)
HOLD_CYCLES_PER_CALL = 1_000_000
EVENT_FALLBACKS: list = []  # times reported by CUDA events after the profiler lost every window
K1_KERNEL = "bit_distance_kernel"  # in the names of both of K1's routes


def log(*parts) -> None:
    print(*parts, flush=True)


# -- phases -------------------------------------------------------------------


def phase_environment(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] card: {smi}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import msgpack

    try:
        import yaml  # noqa: F401
        have_yaml = True
    except ImportError:
        have_yaml = False
    log(f"[env] msgpack {msgpack.version}, yaml importable: {have_yaml}")
    return {"smi": smi, "have_yaml": have_yaml}


def phase_build():
    """Build K1-K5, K9-K11 and the key-value store at once, one compiler each."""
    from semadb_tpu_torch.ops.kernels import (
        gather, hamming, ivf_pq_scan, ivf_probe_topk, ivf_rerank, ivf_scan, vamana_prune, vamana_search,
    )
    from semadb_tpu_torch.store import native
    from semadb_tpu_torch.utils.build import BUILD_DIR

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    kernels = (("K1", hamming), ("K2", gather), ("K3", ivf_scan), ("K4", ivf_rerank), ("K5", ivf_probe_topk),
               ("K9", ivf_pq_scan), ("K10", vamana_search), ("K11", vamana_prune))
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        jobs = {name: pool.submit(timed, mod._library) for name, mod in kernels}
        jobs["kvstore"] = pool.submit(timed, native.load_library)
        took = {name: job.result() for name, job in jobs.items()}
    if native.load_library() is None:
        raise RuntimeError(f"the key-value store {native.SOURCE} did not build")
    log(f"[build] into {BUILD_DIR}, all at once in {time.perf_counter() - t0:.2f} s")
    for name, mod in kernels:
        built = "built now" if mod.BUILD_LOG else "found built from this source hash"
        log(f"[build] {name} {mod.SOURCE}: {built} in {took[name]:.2f} s")
        for line in mod.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] kvstore {native.SOURCE}: loaded in {took['kvstore']:.2f} s")
    return hamming, gather, ivf_scan, ivf_rerank, ivf_probe_topk, ivf_pq_scan, vamana_search, vamana_prune


def _check_k1(torch, hamming, q, x, what: str) -> float:
    """K1 on every route against its plain version, both metrics, exactly;
    returns the largest |error| (0.0 when it passes)."""
    worst = 0.0
    for metric in hamming.METRIC_FLAGS:
        want = hamming.pairwise_bit_distance_plain(q, x, metric)
        for route in hamming.ROUTES:
            got = hamming.pairwise_bit_distance_kernel(q, x, metric, route=route)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"K1 {route} {metric} {what}: bad output {tuple(got.shape)}")
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {route} {metric} {what}: differs from plain, max |err| {err}")
    return worst


def phase_kernel(torch, hamming, device) -> float:
    gen = torch.Generator(device="cpu").manual_seed(1234)
    worst = 0.0
    for b, n, w in KERNEL_SHAPES:
        q = torch.randint(-2**31, 2**31 - 1, (b, w), generator=gen, dtype=torch.int64).to(torch.int32)
        x = torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen, dtype=torch.int64).to(torch.int32)
        q[0] = 0  # a zero query row: jaccard's empty union against zero codes
        x[0] = 0
        worst = max(worst, _check_k1(torch, hamming, q.to(device), x.to(device), f"B={b} N={n} W={w}"))
    log(f"[kernel] K1 == plain (torch.equal) at {len(KERNEL_SHAPES)} shapes x 2 metrics x "
        f"routes {'/'.join(hamming.ROUTES)}; max |err| {worst}")
    return worst


def phase_slice(torch, hamming, gather, device, seed: int):
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.vectorstore import bq_encode

    queries = bq.queries(seed, max(10 + 64, *TIMED_B))
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_") as root:
        cfg = bq.slice_config(root)
        hamming.LAUNCHES = gather.LAUNCHES = 0  # counts from here on are the slice's
        hamming.LAUNCHES_BY.clear()
        with bq.serving(cfg, device) as srv:
            data = bq.load(srv, seed, bq.N_POINTS)
            counts = data.shard_counts
            assert len(counts) >= 2, f"expected a multi-shard collection, got {counts}"
            log(f"[slice] store backend of the shards: {data.store_backend}")
            log(f"[slice] ingest: {bq.N_POINTS} points in {data.seconds:.2f} s = {data.rate:.1f} points/s "
                f"(first {bq.HTTP_POINTS} over HTTP JSON in {data.http_seconds:.2f} s; then "
                f"Point.from_map {data.encode_seconds:.2f} s, ClusterNode.insert_points "
                f"{data.insert_seconds:.2f} s); {len(counts)} shards, points per shard {sorted(counts)}")

            def check(q, points, what):
                errs = bq.brute_force_errors(q, points, data, LIMIT)
                if errs:
                    raise AssertionError(f"{what}: {errs}")

            lat = []
            for i in range(10):
                t1 = time.perf_counter()
                res = bq.http_json(srv.base, "POST", f"/{bq.COLLECTION}/points/search",
                                   bq.search_body(queries[i], LIMIT))
                lat.append(time.perf_counter() - t1)
                check(queries[i], res["points"], f"single search {i}")
            t1 = time.perf_counter()
            res = bq.http_json(srv.base, "POST", f"/{bq.COLLECTION}/points/search/batch",
                               {"queries": [bq.search_body(q, LIMIT) for q in queries[10:10 + 64]]})
            t_batch = time.perf_counter() - t1
            assert len(res["results"]) == 64
            for i, row in enumerate(res["results"]):
                check(queries[10 + i], row["points"], f"batch search {i}")
            launches = hamming.LAUNCHES
            by = dict(hamming.LAUNCHES_BY)
            split = {"b1": sum(v for (_, one), v in by.items() if one),
                     "b_gt1": sum(v for (_, one), v in by.items() if not one)}
            routes = {r: sum(v for (rr, _), v in by.items() if rr == r) for r in hamming.ROUTES}
            if split["b1"] <= 0 or split["b_gt1"] <= 0 or min(routes.values()) <= 0:
                raise AssertionError(f"K1 was not launched at B = 1 and B > 1 on both routes "
                                     f"by the slice's searches: {by}")
            log(f"[slice] K2 launches during the slice: {gather.LAUNCHES} (no search path gathers through it)")
            p50 = float(np.median(lat)) * 1e3
            log(f"[slice] 10 single searches over HTTP: p50 {p50:.2f} ms (min {min(lat) * 1e3:.2f}, "
                f"max {max(lat) * 1e3:.2f}); batch of 64: {t_batch * 1e3:.2f} ms; "
                f"all {10 + 64} match numpy brute force by the tie rule")
            log(f"[slice] K1 launches during the slice: {launches} ({split['b1']} at B = 1, "
                f"{split['b_gt1']} at B > 1; by route {routes}); "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            # The largest shard's own code table, for the timing phase
            largest = max(srv.shard_indices(), key=len)
            qcodes = bq_encode(torch.from_numpy(queries).to(device), largest.store.state.aux, bq.DIM)
            return {"launches": launches, "split": split, "routes": routes,
                    "codes": largest.store.state.codes, "qcodes": qcodes}


def _median_call_ms(torch, fn, runs: int = 30) -> float:
    """Median wall time of one call, host launch work included (CUDA events
    around each call, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_events(torch, fn, runs: int = 30, before=None) -> tuple:
    """``({name: (launches, device us)}, event ms)``: the device events the
    profiler recorded over ``runs`` calls of ``fn`` (a CPU op's device time
    repeats its kernels', so only device-side events count), and the
    CUDA-event time of the same calls, per call. ``before`` runs ahead of
    each call, outside both. The window opens with untimed spin kernels
    (``annbench.prime_profiler``: in this script's process the profiler
    missed the first two or three device events of a window), then one more
    spin, of HOLD_CYCLES_PER_CALL a call, holds the device while the host
    queues the calls, so the event pair around each call times it on the
    device, not the host's launch work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semadb_tpu_torch.tools.annbench import PRIME_KERNEL, prime_profiler

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prime_profiler()
        torch.cuda._sleep(HOLD_CYCLES_PER_CALL * runs)
        for start, end in pairs:
            if before is not None:
                before()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
    events = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and PRIME_KERNEL not in e.key}
    return events, sum(start.elapsed_time(end) for start, end in pairs) / runs


def _named(key: str, names) -> bool:
    return any(name in key for name in ((names,) if isinstance(names, str) else names))


def _device_ms(torch, fn, runs: int = 30, before=None, kernel=None) -> float:
    """Device time per call: the time of the device events over ``runs``
    calls of ``fn`` (only events whose name holds ``kernel``, a name or a
    tuple of names, when given, averaged over the launches recorded). A
    window that recorded none of them is logged and opened again (P2: in
    this script's process the profiler has lost device events); after
    PROFILER_WINDOWS such windows the CUDA-event time of the last window's
    calls is reported instead, and logged: a lost window never fails the
    run."""
    for window in range(PROFILER_WINDOWS):
        recorded, event_ms = _device_events(torch, fn, runs, before)
        events = {k: v for k, v in recorded.items() if kernel is None or _named(k, kernel)}
        total_us = sum(us for _, us in events.values())
        if total_us > 0:
            calls = sum(n for n, _ in events.values()) if kernel is not None else runs
            return total_us / 1e3 / calls
        log(f"[profiler] window {window + 1} of {PROFILER_WINDOWS} recorded no device time of "
            f"{kernel or 'any kernel'} in {runs} calls (recorded: {sorted(recorded)})")
    EVENT_FALLBACKS.append(f"{kernel or 'all kernels'}: {event_ms:.4f} ms")
    log(f"[profiler] {PROFILER_WINDOWS} windows lost {kernel or 'every kernel'}: reporting the CUDA-event time of "
        f"the last window's calls, {event_ms:.4f} ms a call; its device time by kernel is not measured")
    return event_ms


def _k3_device_ms(torch, ivf_scan, ops, chunks: int = 1, runs: int = 20) -> dict:
    """K3's device time per call: every device event of the calls (its
    kernels and the memset of its work area) over the calls, held to the
    CUDA-event time of the same calls in the same window: it must lie within
    K3_EVENT_SHARE-100% of it. Each event must record one launch a call and
    chunk; a window that lost launches (P2: in this script's process the
    profiler drops events) is taken only if it kept at least half of each
    event's launches (each event's time divided by the launches it kept) and
    passes that check. A window that is not taken is logged and opened again;
    after PROFILER_WINDOWS of them the CUDA-event time of the last window's
    calls is reported, ``by_kernel_ms`` is "not measured", and the run goes
    on. A device event that is not K3's fails the run."""
    names = ivf_scan.KERNELS + ("Memset",)
    want = runs * chunks
    for window in range(PROFILER_WINDOWS):
        events, event_ms = _device_events(torch, functools.partial(ivf_scan.ivf_probe_scan, *ops), runs)
        other = {k for k in events if not _named(k, names)}
        if other:
            raise AssertionError(f"K3: device events that are not K3's: {sorted(other)}")
        hits = {name: [(n, us) for key, (n, us) in events.items() if name in key] for name in names}
        got = {name: sum(n for n, _ in h) for name, h in hits.items()}
        out = {"event_ms": event_ms, "kernels_per_call": len(names) * chunks, "launches_recorded": got}
        if not all(2 * n >= want for n in got.values()):
            log(f"[profiler] window {window + 1} of {PROFILER_WINDOWS} recorded {got} launches of K3's events in "
                f"{runs} calls of {chunks} chunk(s), not {want} each")
            continue
        by = {name: sum(us for _, us in h) / 1e3 / got[name] * chunks for name, h in hits.items()}
        ms = sum(by.values())
        if K3_EVENT_SHARE * event_ms <= ms <= event_ms:
            return {**out, "ms": ms, "by_kernel_ms": by, "share": ms / event_ms, "measured_by": "profiler"}
        log(f"[profiler] window {window + 1} of {PROFILER_WINDOWS}: K3's profiler time {ms:.4f} ms a call "
            f"(launches recorded {got}, {want} each a window) is not within {K3_EVENT_SHARE:.0%}-100% of the same "
            f"calls' CUDA-event time, {event_ms:.4f} ms")
    EVENT_FALLBACKS.append(f"K3 ({chunks} chunk(s)): {event_ms:.4f} ms")
    log(f"[profiler] K3: no window of {PROFILER_WINDOWS} was taken; reporting the CUDA-event time of the last "
        f"window's calls, {event_ms:.4f} ms a call; K3's time by kernel is not measured")
    return {**out, "ms": event_ms, "by_kernel_ms": "not measured", "share": None, "measured_by": "cuda events"}


def _by_kernel_text(t3) -> str:
    by = t3["by_kernel_ms"]
    return by if isinstance(by, str) else ", ".join(f"{n} {v:.4f}" for n, v in by.items())


def _l2_flush(torch):
    """A call that writes FLUSH_BYTES and reads as many more, so that the
    50 MB L2 holds none of the next kernel's operands and no dirty lines."""
    written = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    read = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flush():
        written.zero_()
        read.sum()

    return flush


def phase_timing(torch, hamming, codes, qcodes) -> dict:
    """K1's routes and its plain version at the slice's shapes, on the
    largest shard's own code table. First every route must equal the plain
    version on these operands; then each route's device time, warm and
    L2-cold, against the byte bound; the plain version's device time and a
    call's time with its host launch work at B = 1 and 64; and both routes
    cold across the route threshold."""
    n, w = codes.shape
    flush = _l2_flush(torch)
    out = {}
    for b in TIMED_B:
        q = qcodes[:b].contiguous()
        err = _check_k1(torch, hamming, q, codes, f"on the shard's codes B={b} N={n} W={w}")
        row = {"n": n, "w": w, "max_abs_err": err, "route": hamming.route_for(b, w)}
        for route in hamming.ROUTES:
            call = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming", route=route)
            call()
            row[route] = {"warm": _device_ms(torch, call, kernel=K1_KERNEL),
                          "cold": _device_ms(torch, call, before=flush, kernel=K1_KERNEL)}
        kernel = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming")
        plain = functools.partial(hamming.pairwise_bit_distance_plain, q, codes, "hamming")
        if b != TIMED_B[-1]:  # the plain version is compared at B = 4096 but not timed
            row["call_ms"] = _median_call_ms(torch, kernel)
            row["plain_call_ms"] = _median_call_ms(torch, plain)
            row["plain_ms"] = _device_ms(torch, plain)
        moved = n * w * 4 + b * w * 4 + b * n * 4  # codes + queries in, distances out
        row["bound_ms"] = _bound_ms(moved)
        row["int8_ops_ms"] = 2 * b * n * 32 * w / INT8_OPS_PER_S * 1e3
        row["ms"] = row[row["route"]]["cold"]
        row["share"] = row["bound_ms"] / row["ms"]
        times = "; ".join(f"{r} {row[r]['cold']:.5f} ms cold, {row[r]['warm']:.5f} ms warm"
                          for r in hamming.ROUTES)
        log(f"[timing] K1 == plain on the shard's codes B={b} N={n} W={w}, both metrics, every route; "
            f"max |err| {err}")
        log(f"[timing] K1 hamming B={b}: {times} (device time per call, mean of 30)")
        plain_txt = (f"plain {row['plain_ms']:.5f} ms on the device, {row['plain_call_ms']:.5f} ms a call; "
                     f"kernel {row['call_ms']:.5f} ms a call (median of 30)" if "plain_ms" in row
                     else "plain compared, not timed")
        log(f"[timing] K1 B={b} bound {row['bound_ms']:.6f} ms by bytes ({moved} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s; the int8-rate operations term, for information: "
            f"{row['int8_ops_ms']:.6f} ms); the {row['route']} route (the wrapper's at this B) cold "
            f"at {row['share']:.1%} of the bound; {plain_txt}")
        out[b] = row
    sweep = {}
    for b in THRESHOLD_B:
        q = qcodes[:b].contiguous()
        sweep[b] = {}
        for route in hamming.ROUTES:
            call = functools.partial(hamming.pairwise_bit_distance_kernel, q, codes, "hamming", route=route)
            call()
            sweep[b][route] = _device_ms(torch, call, before=flush, kernel=K1_KERNEL)
    cold = {b: {r: out[b][r]["cold"] for r in hamming.ROUTES} for b in TIMED_B}
    cold.update(sweep)
    log("[timing] K1 hamming cold by B, route threshold TENSOR_MIN_B = "
        f"{hamming.TENSOR_MIN_B}: " + "; ".join(
            f"B={b} " + " / ".join(f"{r} {cold[b][r]:.5f}" for r in hamming.ROUTES) for b in sorted(cold)))
    return {"by_b": out, "threshold_sweep": sweep}


def _bound_ms(nbytes: int) -> float:
    """The least time for the work: its bytes over the memory rate. (K1's
    bit operations have no published tensor-core rate to bound them by.)"""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _gather_ids(torch, gen, n, cap, device):
    ids = torch.randint(0, cap, (n,), generator=gen, dtype=torch.int32, device=device)
    ids[0] = 0
    if n > 1:
        ids[-1] = cap - 1
    if n > 2:
        ids[n // 2] = ids[-1]  # a repeat
    return ids


def phase_gather_kernel(torch, gather, device) -> float:
    """K2 against its plain version at every listed shape, exactly, and its
    refusals."""
    gen = torch.Generator(device=device).manual_seed(4321)
    worst = 0.0
    cases = 0
    for d, n, cap in GATHER_SHAPES:
        vectors = torch.randn((cap, d), generator=gen, device=device)
        ids = _gather_ids(torch, gen, n, cap, device)
        got = gather.gather_rows_padded(vectors, ids, check=True)
        torch.cuda.synchronize()
        want = gather.gather_rows_plain(vectors, ids)
        if got.shape != (n, d) or not torch.equal(got, want):
            raise AssertionError(f"K2 D={d} n={n} cap={cap}: kernel != plain")
        if n % gather.TILE == 0 and not torch.equal(gather.gather_rows(vectors, ids, check=True), want):
            raise AssertionError(f"K2 gather_rows D={d} n={n} cap={cap}: kernel != plain")
        worst = max(worst, (got - want).abs().max().item())
        cases += 1
    flat = torch.randn(1 + 4096 * 128, generator=gen, device=device)
    vectors = flat[1:].view(4096, 128)  # 4 bytes off the 16-byte grid: the 4-byte copy
    ids = _gather_ids(torch, gen, 100003, 4096, device)
    if not torch.equal(gather.gather_rows_padded(vectors, ids, check=True), gather.gather_rows_plain(vectors, ids)):
        raise AssertionError("K2 on rows off the 16-byte grid: kernel != plain")
    try:
        gather.gather_rows(vectors, ids[:1000])
    except ValueError:
        pass
    else:
        raise AssertionError("gather_rows took 1000 ids, not a multiple of 1024")
    for bad in (4096, -1):
        bad_ids = ids[:64].clone()
        bad_ids[17] = bad
        try:
            gather.gather_rows_padded(vectors, bad_ids, check=True)
        except IndexError:
            pass
        else:
            raise AssertionError(f"K2's checked path took the id {bad} of a 4096-row matrix")
    torch.cuda.synchronize()
    log(f"[gather] K2 == plain (torch.equal) at {cases} shapes and on unaligned rows; max |err| {worst}; "
        f"gather_rows refuses n % 1024 != 0; the checked path refuses ids 4096 and -1 of 4096 rows")
    return worst


def phase_gatherbench(torch, hamming, gather) -> dict:
    """The gather path: the port's gatherbench at its defaults on cuda."""
    from semadb_tpu_torch.tools import gatherbench

    hamming.LAUNCHES = gather.LAUNCHES = 0  # counts from here on are the gatherbench path's
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gatherbench.main([])
    launches = gather.LAUNCHES
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[gatherbench] {json.dumps(res)}")
    if rc != 0 or res["kernel_correct"] is not True:
        raise AssertionError(f"gatherbench: the kernel's output differs from index_select (rc {rc})")
    if res["platform"] != "cuda" or launches <= 0:
        raise AssertionError(f"gatherbench did not run K2 on the card: {res['platform']}, {launches} launches")
    bound_ms, bound_by = _bound_ms(res["bound_bytes"]), "bytes"
    ms = {k: res[f"{k}_s"] * 1e3 for k in ("kernel", "torch", "plain")}
    log(f"[gatherbench] K2 launches: {launches}; K1 launches: {hamming.LAUNCHES}; "
        f"{res['unique_rows']} distinct of {res['rows']} rows of {res['row_bytes']} B")
    log(f"[gatherbench] kernel {ms['kernel']:.4f} ms ({res['kernel_gbps']:.1f} GB/s of output), "
        f"index_select {ms['torch']:.4f} ms ({res['torch_gbps']:.1f} GB/s), plain {ms['plain']:.4f} ms "
        f"({res['plain_gbps']:.1f} GB/s); bound {bound_ms:.4f} ms by {bound_by} "
        f"({res['bound_bytes']} B at {HBM_BYTES_PER_S:.3g} B/s); kernel at {bound_ms / ms['kernel']:.1%}, "
        f"index_select at {bound_ms / ms['torch']:.1%} of the bound")
    return {"launches": launches, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


# -- the IVF engine: K3, K4 and the bench cell ---------------------------------

K3_BS, K3_PS, K3_SS, K3_RS, K3_RRS = (1, 7, 64, 4096), (1, 5, 24, 96), (64, 128, 192), (3, 100, 128), (20, 64, 256)
K4_DS, K4_KS = (3, 128, 1536), (1, 10, 100)
K4_ROUTE_DS, K4_ROUTE_KS = (3, 4, 128, 1536, 4096), (1, 10, 32, 33, 100)
K4_RRS, K4_BS = (20, 64, 256, 2048), (1, 7, 4096)
K3_SWEEP_B = (1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096)
# K3 at the 10M cell's cluster count: 32 tiles of 4,096 clusters in the
# offsets look-back scan
K3_BIG_C, K3_BIG_S, K3_BIG_R, K3_BIG_RR = 131_072, 192, 128, 64
K3_BIG_BS, K3_BIG_PS = (1, 4096), (24, 96)
K4_SWEEP_B = (1, 64, 264, 512, 1024, 2048, 4096)
IVF_RTOL = 1e-5  # of the magnitude of the summed terms: the sums run in another order
IVF_TIMED_RUNS = 20
K4_PROJ_ROWS, K4_PROJ_D, K4_PROJ_RR, K4_PROJ_B = 400_000, 1536, 256, 4096  # the projected traversal
HTTP_IVF_POINTS = 20_000
# Phase 9: the reference text bench's corpus (bench.py:806-850): 100,000
# documents of 12 terms, Zipf (s = 1.1) over a 20,000-word vocabulary,
# inserted 10,000 a write transaction; beside them a 128-d vector and three
# fields to filter on
HYBRID_POINTS, HYBRID_DIM, HYBRID_BATCH = 100_000, 128, 10_000
HYBRID_VOCAB, HYBRID_TERMS, HYBRID_ZIPF = 20_000, 12, 1.1
HYBRID_CATEGORIES, HYBRID_CATEGORY_ZIPF = 20, 1.5  # the rarest ~0.5%, the commonest ~45%
HYBRID_YEARS = (1990, 2024)
HYBRID_TAGS = 50
HYBRID_PAGE = 75  # config/singleServer.yaml's maxSearchLimit
HYBRID_QUERIES = 8  # held-out vectors, each kind of vector query runs on every one
TEXT_RTOL = 1e-5  # the index keeps tf in f32
WIDE_FILTER_SHARE, WIDE_QUERIES, WIDE_RECALL = 0.5, 256, 0.95
HTTP_IVF_DIM = 128
HTTP_IVF_RECALL = 0.95
CELL_RECALL = 0.99
LIBRARY_NONE = ("none: no single PyTorch call gathers probed slabs and keeps a top-rr "
                "(index_select + bmm + topk are three calls and materialise [B, p*S])")
LIBRARY_NONE_K4 = ("none: no single PyTorch call gathers pool rows and takes an exact top-k "
                   "(index_select + bmm + topk are three calls)")
LIBRARY_NONE_K9 = ("none: no single PyTorch call looks u8 codes up in per-query tables and keeps a top-rr "
                   "(take_along_dim + sum + topk are three calls and materialise [B, p*S, M])")
LIBRARY_NONE_K9_DENSE = ("none: no single PyTorch call sums the per-query table entries u8 codes select "
                         "(take_along_dim + sum are two calls and materialise [B, N, M])")
# K9's probed entry: (B, p, S, M, K, rr, mask), every value of each parameter;
# the last two are the IVF-PQ cell's shape
K9_CASES = [
    (1, 1, 64, 2, 16, 20, False), (1, 24, 256, 128, 256, 2048, True), (1, 96, 128, 8, 256, 256, False),
    (7, 1, 128, 4, 256, 20, True), (7, 24, 64, 16, 16, 256, False), (7, 96, 256, 128, 16, 2048, True),
    (64, 1, 256, 8, 16, 2048, False), (64, 24, 128, 2, 256, 20, True), (64, 96, 64, 16, 256, 256, True),
    (4096, 1, 64, 4, 16, 256, False), (4096, 24, 256, 16, 256, 20, True), (4096, 96, 128, 4, 16, 2048, False),
    (4096, 24, 128, 8, 256, 256, False), (4096, 24, 128, 8, 256, 256, True),
]
# K9's dense entry: (B, N, M, K, mask)
K9_DENSE_CASES = [
    (1, 1, 8, 256, False), (3, 1, 2, 16, True), (64, 100_003, 8, 256, True), (7, 100_003, 128, 256, True),
    (4096, 4096, 8, 256, True), (1, 100_003, 16, 16, False),
]
# K9's probed entry at the layouts that stress its selection: (B, p, S, M, K,
# rr, mask, layout, chunk). "dup-probes": each query probes a cluster twice
# and holds probes of -1 and C; "ties": tables of the integers -2..2 (K = 16,
# M = 2: many equal scores at the cut); "negative": every entry below -1;
# "all-nil": half the clusters hold no live slot; "nil": no slot is live;
# "sparse": 85% NIL slots, so rr exceeds the live slots. chunk, when given,
# patches the most slots a block scores between two selections, so queries
# take several (the kept set, the running bound)
K9_LAYOUT_CASES = [
    (64, 24, 128, 8, 256, 256, False, "dup-probes", None), (4096, 24, 128, 8, 256, 256, True, "dup-probes", None),
    (4096, 24, 64, 2, 16, 256, False, "ties", None), (1024, 24, 128, 2, 16, 2048, False, "ties", None),
    (7, 96, 128, 2, 16, 20, True, "ties", 256), (64, 24, 128, 8, 256, 256, False, "negative", None),
    (64, 24, 128, 8, 256, 256, True, "all-nil", None), (7, 24, 128, 8, 256, 256, False, "nil", None),
    (4096, 24, 128, 8, 256, 2048, False, "sparse", None), (1, 5, 64, 4, 16, 256, False, "sparse", None),
    (64, 24, 128, 8, 256, 256, True, None, 256), (4096, 24, 128, 8, 256, 256, False, "negative", 512),
]
# Calls of K9 at the IVF-PQ cell's shape that must repeat the first bit for bit
K9_REPEATS = 50
# Rows of K9's dense entry timed at the IVF-PQ cell's batch: the overflow
# pool's floor from 2^17 points (index/ivf.py)
K9_DENSE_ROWS = 4096
PQ_CELL_ARGV = ("--quantizer", "product")
PQ_CELL_RECALL = 0.95
FUSED_CELL_ARGV = ("--fused",)
FUSED_CELL_RECALL = 0.97
# The fused cell's shapes, as the code predicts them: 128 + 64 + 2 norm
# columns, no projection, S = 256 (copies 4), bf16 slabs
FUSED_CELL_SHAPE = {"aug_dim": 194, "slab": 256, "slab_dtype": "bfloat16", "projected": False}
HTTP_PQ_POINTS = 20_000
HTTP_PQ_RECALL = 0.9
HTTP_VIEWS = (128, 64)


def k3_cases():
    """Every value of each K3 parameter, in 20 combinations: the 16 (B, p)
    pairs with S, r, rr, slab type and mask cycling; the bench cell's shape
    (B 4096, p 24, S 128, r 128, rr 64) in both slab types, with and without
    a mask; and the layouts of a batch at the cell's widths: every query on
    the same probes, ids in two clusters, holes in the live prefixes, and B
    in chunks. Each is (B, p, S, r, rr, bf16, mask, layout)."""
    cases = []
    for i, (b, p) in enumerate((b, p) for b in K3_BS for p in K3_PS):
        cases.append((b, p, K3_SS[i % 3], K3_RS[(i // 3) % 3], K3_RRS[(i + 1) % 3], i % 2 == 1, (i // 2) % 2 == 1,
                      None))
    cases += [(4096, 24, 128, 128, 64, bf16, mask, None) for bf16 in (False, True) for mask in (False, True)]
    # The fused cell's shape: 194 columns, S = 256, bf16
    cases += [(4096, 24, 256, 194, 64, True, False, None), (64, 24, 256, 194, 64, True, True, None)]
    cases += [
        (4096, 24, 128, 128, 64, False, False, "same-probes"),
        (64, 24, 128, 128, 64, True, True, "same-probes"),
        (4096, 24, 128, 128, 64, False, False, "copies"),
        (7, 5, 64, 100, 20, True, True, "copies"),
        (4096, 24, 128, 128, 64, False, True, "holes"),
        (64, 8, 192, 3, 256, True, False, "holes"),
        (1000, 24, 128, 128, 64, False, True, "chunked"),
        (3, 40, 1024, 8, 2048, False, False, "chunked"),
    ]
    return cases


def k4_cases():
    """D x k x metric, 27 combinations (rr = max(64, 2k)); B cycles through
    1, 7, 64 and 4096 (4096 only at D = 128, where the bench cell runs);
    then D x metric with pools that repeat ids, deduplicated by the kernel
    (9 more). Then the routes of the bulk-copy design: D in {3, 4, 128, 1536,
    4096} x k in {1, 10, 32, 33, 100}, rr cycling through {20, 64, 256, 2048}
    and B through {1, 7, 4096}; bases off the 16-byte grid; pools with every
    id 2-3 times; a pool that is all empty. Each is (B, D, k, rr, metric,
    dedup, layout)."""
    metrics = ("euclidean", "dot", "cosine")
    cases = []
    for i, (d, k, metric) in enumerate((d, k, m) for d in K4_DS for k in K4_KS for m in metrics):
        b = 4096 if d == 128 and i % 3 == 0 else (1, 7, 64)[i % 3]
        cases.append((b, d, k, max(64, 2 * k), metric, False, None))
    for d in K4_DS:
        for metric in metrics:
            cases.append((4096 if d == 128 and metric == "euclidean" else 64, d, 10, 64, metric, True, None))
    for i, (d, k) in enumerate((d, k) for d in K4_ROUTE_DS for k in K4_ROUTE_KS):
        rr = K4_RRS[i % len(K4_RRS)]
        # B = 4096 where the plain version's gather stays under 2^31 elements
        b = K4_BS[i % len(K4_BS)]
        if b * rr * d > 2**31:
            b = 7
        cases.append((b, d, k, rr, metrics[i % 3], i % 2 == 0, None))
    cases += [
        (64, 128, 10, 64, "euclidean", True, "offgrid"), (7, 1536, 33, 256, "dot", False, "offgrid"),
        (4096, 128, 10, 64, "euclidean", True, "copies"), (64, 1536, 10, 256, "cosine", True, "copies"),
        (7, 3, 32, 20, "dot", True, "copies"), (1, 4096, 10, 2048, "euclidean", True, "copies"),
        (7, 128, 10, 64, "euclidean", True, "empty"), (1, 1536, 33, 256, "cosine", False, "empty"),
        # the fused cell's rows (194 columns: the element route), dot, copies
        (4096, 194, 10, 64, "dot", True, None), (1, 194, 10, 64, "dot", True, None),
    ]
    return cases


def _k4_operands(torch, gen, b, d, rr, metric, dedup, layout, device):
    """Random rows and queries (unit rows for cosine); pools of distinct ids,
    a quarter repeated under dedup (or every id 2-3 times: "copies"); 20% of
    the slots empty by their coarse score and 5% by an id of -1 ("empty":
    every slot); "offgrid": the matrix one float off the 16-byte grid."""
    cap = 5000
    vectors = torch.randn((cap, d), generator=gen)
    queries = torch.randn((b, d), generator=gen)
    if metric == "cosine":
        vectors = vectors / vectors.norm(dim=1, keepdim=True)
        queries = queries / queries.norm(dim=1, keepdim=True)
    pool = torch.argsort(torch.rand((b, cap), generator=gen), dim=1)[:, :rr].to(torch.int32)
    if layout == "copies":
        reps = torch.randint(2, 4, (b, rr), generator=gen).cumsum(1)
        pool = torch.gather(pool, 1, torch.searchsorted(reps, torch.arange(rr).expand(b, rr).contiguous(),
                                                        right=True))
        pool = torch.gather(pool, 1, torch.argsort(torch.rand((b, rr), generator=gen), dim=1))
    elif dedup:
        again = torch.rand((b, rr), generator=gen) < 0.25
        pool = torch.where(again, torch.gather(pool, 1, torch.randint(0, rr, (b, rr), generator=gen)), pool)
    coarse = torch.randn((b, rr), generator=gen)
    empty = torch.rand((b, rr), generator=gen) < 0.2
    coarse[empty] = float("inf")
    pool[empty & (torch.rand((b, rr), generator=gen) < 0.5)] = -1
    if layout == "empty":
        coarse[:] = float("inf")
    ops = [t.to(device) for t in (vectors, queries, pool, coarse)]
    if layout == "offgrid":
        flat = torch.empty(cap * d + 1, device=device)
        ops[0] = flat[1:].view(cap, d)
        ops[0].copy_(vectors)
    return ops


def check_rows(torch, want, got, dist_of, atol, what) -> float:
    """Hold every row of ``got`` (d, i) against ``want`` by the multiset tie
    rule (``ops.topk.pool_errors``); rows that match exactly (ids equal,
    distances within atol) need no lookups. Returns the largest |error| of
    the finite distances."""
    from semadb_tpu_torch.ops.topk import pool_errors

    wd, wi = (t.cpu() for t in want)
    gd, gi = (t.cpu() for t in got)
    if gd.shape != wd.shape or gi.shape != wi.shape:
        raise AssertionError(f"{what}: shapes {tuple(gd.shape)} vs {tuple(wd.shape)}")
    atol = torch.as_tensor(atol, dtype=torch.float64).reshape(-1, 1).expand(wd.shape[0], 1)
    fin = torch.isfinite(wd) & torch.isfinite(gd)
    diff = torch.where(fin, (gd.double() - wd.double()).abs(), torch.zeros((), dtype=torch.float64))
    if not torch.equal(torch.isfinite(wd), torch.isfinite(gd)):
        bad = (torch.isfinite(wd) != torch.isfinite(gd)).any(1).nonzero()[:3, 0].tolist()
        raise AssertionError(f"{what}: finite places differ in rows {bad}")
    same = torch.equal(gi, wi) and bool((diff <= atol).all())
    if not same:
        rows = ((gi != wi).any(1) | (diff > atol).any(1)).nonzero()[:, 0].tolist()
        for b in rows:
            errs = pool_errors(wd[b].tolist(), wi[b].tolist(), gd[b].tolist(), gi[b].tolist(),
                               lambda i, b=b: dist_of(b, i), float(atol[b, 0]))
            if errs:
                raise AssertionError(f"{what}, row {b}: {errs}")
    return float(diff.max()) if diff.numel() else 0.0


def _k3_operands(torch, gen, b, p, s, r, bf16, masked, device, layout=None):
    c = max(2 * p, 32)
    rows = torch.randn((c, s, r), generator=gen)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    nil = torch.rand((c, s), generator=gen) < 0.3
    if layout == "holes":  # live prefixes of random length, 10% of them deleted
        fill = torch.randint(s // 2, s + 1, (c, 1), generator=gen)
        nil = (torch.arange(s)[None, :] >= fill) | (torch.rand((c, s), generator=gen) < 0.1)
    ids[nil] = -1
    rows[nil] = 0.0
    if layout == "copies":  # each cluster's first quarter also fills the next cluster's last slots
        q4 = s // 4
        ids[:, s - q4:] = ids.roll(1, dims=0)[:, :q4].clone()
        rows[:, s - q4:] = rows.roll(1, dims=0)[:, :q4].clone()
    slabs = rows.to(torch.bfloat16) if bf16 else rows
    slab_sq = (rows * rows).sum(-1)
    qp = torch.randn((b, r), generator=gen)
    if layout == "same-probes":
        probe = torch.randperm(c, generator=gen)[:p].to(torch.int32).expand(b, p).contiguous()
    else:
        probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32).contiguous()
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    ops = [qp, probe, slabs, slab_sq, ids, mask]
    return [None if t is None else t.to(device) for t in ops]


def _k3_dist_of(torch, qp, slabs, slab_sq, slab_ids):
    """id → its coarse score for query b, in f64 on the host (first copy),
    through a sorted index of the slots' ids made at the first lookup (a
    scan of every slot a lookup is too slow at 131,072 x 192 slots)."""
    index = {}

    def dist_of(b, i):
        if not index:
            ids_h = slab_ids.cpu().numpy().reshape(-1)
            index["order"] = np.argsort(ids_h, kind="stable")
            index["sorted"] = ids_h[index["order"]]
        cell = int(index["order"][np.searchsorted(index["sorted"], i)])
        row = slabs.reshape(-1, slabs.shape[-1])[cell].double().cpu()
        sq = float(slab_sq.reshape(-1)[cell])
        return sq - 2.0 * float(row @ qp[b].double().cpu())

    return dist_of


def _k3_atol(torch, qp, slabs):
    """Per query: IVF_RTOL x (|x|max^2 + 2 |x|max |q|), the size of the terms."""
    xmax = max(float(slabs[c0 : c0 + 4096].float().norm(dim=-1).max()) for c0 in range(0, slabs.shape[0], 4096))
    return (IVF_RTOL * (xmax * xmax + 2.0 * xmax * qp.double().norm(dim=1))).cpu()


def _k3_big_checks(torch, ivf_scan, device) -> tuple:
    """K3 against its plain version over the 131,072-cluster slab set (32
    tiles of the offsets scan) at B in {1, 4096} x p in {24, 96}, with and
    without the mask; returns (cases, largest |error|)."""
    gen, slabs, slab_sq, ids, mask = ivf_scan.random_operands(K3_BIG_C, K3_BIG_S, K3_BIG_R, 131072, device)
    worst, cases = 0.0, []
    for b in K3_BIG_BS:
        qp = torch.randn((b, K3_BIG_R), generator=gen, device=device)
        dist_of = _k3_dist_of(torch, qp, slabs, slab_sq, ids)
        atol = _k3_atol(torch, qp, slabs)
        for p in K3_BIG_PS:
            probe = torch.topk(torch.rand((b, K3_BIG_C), generator=gen, device=device), p, dim=1).indices
            probe = probe.to(torch.int32).contiguous()
            for m in (None, mask):
                ops = (qp, probe, slabs, slab_sq, ids, m, K3_BIG_RR)
                what = f"K3 C={K3_BIG_C} B={b} p={p} S={K3_BIG_S} r={K3_BIG_R} bf16 mask={m is not None}"
                got = ivf_scan.ivf_probe_scan(*ops)
                torch.cuda.synchronize()
                worst = max(worst, check_rows(torch, ivf_scan.ivf_probe_scan_plain(*ops), got, dist_of, atol, what))
                cases.append((b, p, m is not None))
    del slabs, slab_sq, ids, mask
    torch.cuda.empty_cache()
    return cases, worst


def _k4_atol(torch, vectors, queries):
    xmax = float(vectors.norm(dim=1).max())
    return (IVF_RTOL * ((xmax + queries.double().norm(dim=1)) ** 2 + 1.0)).cpu()


def _k4_dist_of(torch, vectors, queries, metric):
    def dist_of(b, i):
        x, q = vectors[i].double().cpu(), queries[b].double().cpu()
        if metric == "euclidean":
            return float(((x - q) ** 2).sum())
        dot = float(x @ q)
        return 1.0 - dot if metric == "cosine" else -dot
    return dist_of


def phase_ivf_kernels(torch, ivf_scan, ivf_rerank, device) -> dict:
    """K3 and K4 against their plain versions at every listed shape."""
    gen = torch.Generator().manual_seed(2468)
    worst3 = worst4 = 0.0
    chunked = []
    for b, p, s, r, rr, bf16, masked, layout in k3_cases():
        ops = _k3_operands(torch, gen, b, p, s, r, bf16, masked, device, layout)
        what = f"K3 B={b} p={p} S={s} r={r} rr={rr} {'bf16' if bf16 else 'f32'} mask={masked} layout={layout}"
        want = ivf_scan.ivf_probe_scan_plain(*ops, rr)
        dist_of = _k3_dist_of(torch, ops[0], ops[2], ops[3], ops[4])
        atol = _k3_atol(torch, ops[0], ops[2])
        budget = ivf_scan.SCRATCH_BYTES
        if layout == "chunked":  # about 8 chunks
            ivf_scan.SCRATCH_BYTES = p * s * 4 * max(1, b // 8)
            chunked.append((b, ivf_scan.batch_chunk(b, p, s)))
        try:
            got = ivf_scan.ivf_probe_scan(*ops, rr)
            torch.cuda.synchronize()
            worst3 = max(worst3, check_rows(torch, want, got, dist_of, atol, what))
        finally:
            ivf_scan.SCRATCH_BYTES = budget
    big, big_err = _k3_big_checks(torch, ivf_scan, device)
    worst3 = max(worst3, big_err)
    routes = {}
    for b, d, k, rr, metric, dedup, layout in k4_cases():
        vectors, queries, pool, coarse = _k4_operands(torch, gen, b, d, rr, metric, dedup, layout, device)
        route = ivf_rerank.route_of(vectors)
        routes[route] = routes.get(route, 0) + 1
        what = f"K4 B={b} D={d} k={k} rr={rr} {metric} dedup={dedup} layout={layout} route={route}"
        got = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, k, metric, dedup)
        torch.cuda.synchronize()
        want = ivf_rerank.ivf_exact_rerank_plain(vectors, queries, pool, coarse, k, metric, dedup)
        if dedup:
            gi = got[1].cpu()
            if any(len(set(row[row >= 0].tolist())) != int((row >= 0).sum()) for row in gi):
                raise AssertionError(f"{what}: an id came back twice")
        if layout == "empty" and not (torch.isinf(got[0]).all() and (got[1] == -1).all()):
            raise AssertionError(f"{what}: an all-empty pool gave a result")
        worst4 = max(worst4, check_rows(torch, want, got, _k4_dist_of(torch, vectors, queries, metric),
                                        _k4_atol(torch, vectors, queries), what))
    log(f"[ivf-kernels] K3 == plain at {len(k3_cases())} shapes (chunked B, queries a chunk: {chunked}) and at "
        f"C={K3_BIG_C} S={K3_BIG_S} r={K3_BIG_R} bf16 rr={K3_BIG_RR}, (B, p, mask) in {big}; K4 == plain at "
        f"{len(k4_cases())} shapes ({sum(c[5] for c in k4_cases())} with the dedup inside; by route {routes}), "
        f"distances within "
        f"{IVF_RTOL:g} of the terms' magnitude, ids by the tie rule; max |err| K3 {worst3:.3g}, K4 {worst4:.3g}")
    return {"k3_err": worst3, "k4_err": worst4}


# K5 against a float64 reference: (B, C, D, p, metric), a subset of the card
# tests' shapes with the bench cell's and the 10M cell's among them
K5_CHECKS = ((1, 32768, 128, 24, "euclidean"), (7, 1000, 194, 96, "dot"), (64, 131072, 100, 256, "euclidean"),
             (4096, 32768, 128, 24, "euclidean"), (4096, 131072, 128, 24, "dot"), (4096, 32768, 128, 256, "dot"))
# K5 timed at the bench cell's shape, at B = 1 and at the 10M cell's C: (B, C, D, p)
K5_TIMED = ((4096, 32768, 128, 24), (1, 32768, 128, 24), (4096, 131072, 128, 24))


def phase_probe_topk(torch, ivf_probe_topk, device) -> dict:
    """K5 against a float64 reference at K5_CHECKS (ids by the tie rule,
    scores within IVF_RTOL of (|q| + max |c|)^2), then timed beside its plain
    version (the torch chain it replaced) at K5_TIMED: device time a call
    from the profiler's events; bounds, the larger of the operations and the
    bytes (queries, centroids, norms, ids) at 3.35 TB/s, with the products at
    the FFMA rate (67 TFLOP/s) and as three TF32 products (495 TFLOP/s)."""
    from semadb_tpu_torch.ops.topk import tie_rule_errors

    gen = torch.Generator(device=device).manual_seed(1357)

    def operands(b, c, d, metric):
        cents = torch.randn((c, d), generator=gen, device=device)
        q = cents[torch.randint(0, c, (b,), generator=gen, device=device)]
        q = (q + 0.3 * torch.randn((b, d), generator=gen, device=device)).contiguous()
        return q, cents, (cents * cents).sum(-1) if metric == "euclidean" else torch.zeros(c, device=device)

    for b, c, d, p, metric in K5_CHECKS:
        q, cents, sq = operands(b, c, d, metric)
        got = ivf_probe_topk.ivf_probe_topk(q, cents, sq, p)
        torch.cuda.synchronize()
        score = sq.double()[None, :] - 2.0 * (q.double() @ cents.double().T)
        want = torch.topk(score, p, dim=1, largest=False, sorted=True).indices.to(torch.int32)
        atol = IVF_RTOL * (q.double().norm(dim=1) + cents.double().norm(dim=1).max()) ** 2
        rows = (got != want).any(dim=1).nonzero()[:, 0].tolist()
        sc, gh, wh = score.cpu(), got.cpu(), want.cpu()
        for r in rows:
            errs = tie_rule_errors(sc[r, wh[r].long()].tolist(), wh[r].tolist(), sc[r, gh[r].long()].tolist(),
                                   gh[r].tolist(), lambda i, r=r: float(sc[r, i]), atol=float(atol[r]))
            if errs:
                raise AssertionError(f"K5 B={b} C={c} D={d} p={p} {metric}, row {r}: {errs[:3]}")
        log(f"[probe-topk] K5 == float64 at B={b} C={c} D={d} p={p} {metric} ({len(rows)} rows by the tie rule)")
    out = {}
    for b, c, d, p in K5_TIMED:
        q, cents, sq = operands(b, c, d, "euclidean")
        # every device event of the calls: K5's two kernels (the wrapper's buffers launch none)
        k5_ms = _device_ms(torch, functools.partial(ivf_probe_topk.ivf_probe_topk, q, cents, sq, p),
                           runs=IVF_TIMED_RUNS)
        plain_ms = _device_ms(torch, functools.partial(ivf_probe_topk.ivf_probe_topk_plain, q, cents, sq, p),
                              runs=IVF_TIMED_RUNS)
        call_ms = _median_call_ms(torch, functools.partial(ivf_probe_topk.ivf_probe_topk, q, cents, sq, p))
        plain_call_ms = _median_call_ms(torch, functools.partial(ivf_probe_topk.ivf_probe_topk_plain, q, cents, sq, p))
        flops, nbytes = 2 * b * c * d, (b * d + c * d + c + b * p) * 4
        ffma_ms = max(flops / 67e12, nbytes / 3.35e12) * 1e3
        tf32_ms = max(3 * flops / 495e12, nbytes / 3.35e12) * 1e3
        log(f"[probe-topk] K5 B={b} C={c} D={d} p={p} plan {ivf_probe_topk.plan(b, c, p, torch.cuda.get_device_properties(0).multi_processor_count)}: "
            f"{k5_ms:.4f} ms a call on the device ({call_ms:.4f} ms with its host work); bound {ffma_ms:.4f} ms "
            f"in FFMA ({ffma_ms / k5_ms:.1%}), {tf32_ms:.4f} ms as 3xTF32 ({tf32_ms / k5_ms:.1%}); the plain "
            f"version (the torch chain) {plain_ms:.4f} ms ({plain_call_ms:.4f} ms with its host work)")
        out[f"{b}x{c}x{d}p{p}"] = {"ms": k5_ms, "call_ms": call_ms, "plain_ms": plain_ms,
                                   "plain_call_ms": plain_call_ms, "ffma_ms": ffma_ms, "tf32_ms": tf32_ms}
    return out


def _k4_times(torch, ivf_rerank, ops, baseline=None) -> dict:
    """K4's device time per call at ``ops`` (vectors, queries, pool, coarse,
    k, metric, dedup) and at B = 1 (the first query), and at B = 1 a call's
    time with its host work; the same for ``baseline`` (another K4 library,
    e.g. the parent commit's, built from its source) when given."""
    one = (ops[0], ops[1][:1].contiguous(), ops[2][:1].contiguous(), ops[3][:1].contiguous()) + tuple(ops[4:])
    out = {}
    sides = {"": ivf_rerank.ivf_exact_rerank}
    if baseline is not None:
        sides["base_"] = functools.partial(ivf_rerank.launch, baseline)
    for tag, fn in sides.items():
        out[tag + "ms"] = _device_ms(torch, functools.partial(fn, *ops), runs=IVF_TIMED_RUNS, kernel="rerank_kernel")
        out[tag + "b1_ms"] = _device_ms(torch, functools.partial(fn, *one), runs=IVF_TIMED_RUNS,
                                        kernel="rerank_kernel")
        out[tag + "b1_call_ms"] = _median_call_ms(torch, functools.partial(fn, *one))
    return out


def _k4_bytes(torch, vectors, queries, pool, coarse, k) -> tuple:
    """The least bytes of one K4 call: each distinct live pool row once, the
    queries, the pool and coarse scores, the output; and the distinct rows."""
    live = pool[(pool >= 0) & (pool < vectors.shape[0]) & torch.isfinite(coarse)]
    rows = int(torch.unique(live).numel())
    b, d = queries.shape
    return rows * d * 4 + pool.numel() * 8 + b * d * 4 + b * k * 8, rows


def _k4_line(name, t, bound_ms) -> str:
    base = (f"; the parent's design {t['base_ms']:.4f} ms ({bound_ms / t['base_ms']:.1%}), B=1 "
            f"{t['base_b1_ms']:.4f} ms on the device, {t['base_b1_call_ms']:.4f} ms a call" if "base_ms" in t else "")
    return (f"{name}: {t['ms']:.4f} ms a call ({bound_ms / t['ms']:.1%} of the {bound_ms:.4f} ms bound), B=1 "
            f"{t['b1_ms']:.4f} ms on the device, {t['b1_call_ms']:.4f} ms a call (median of 30){base}")


def phase_k4_projected(torch, ivf_rerank, seed: int, baseline=None) -> dict:
    """K4 at the projected traversal's shape (D = 1536, rr = 256, k = 10,
    B = 4,096) over a seeded f32[400,000, 1536] table and random pools, with
    the dedup on (the engine's copies): checked against the plain version,
    then timed, its bound from the distinct rows the pools hold."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1536)
    vectors = torch.randn((K4_PROJ_ROWS, K4_PROJ_D), generator=gen, device="cuda")
    queries = torch.randn((K4_PROJ_B, K4_PROJ_D), generator=gen, device="cuda")
    pool = torch.randint(0, K4_PROJ_ROWS, (K4_PROJ_B, K4_PROJ_RR), generator=gen, device="cuda", dtype=torch.int32)
    coarse = torch.randn((K4_PROJ_B, K4_PROJ_RR), generator=gen, device="cuda")
    ops = (vectors, queries, pool, coarse, LIMIT, "euclidean", True)
    got = ivf_rerank.ivf_exact_rerank(*ops)
    want = ivf_rerank.ivf_exact_rerank_plain(*ops)
    err = check_rows(torch, want, got, _k4_dist_of(torch, vectors, queries, "euclidean"),
                     _k4_atol(torch, vectors, queries), "K4 at the projected shape")
    nbytes, rows = _k4_bytes(torch, vectors, queries, pool, coarse, LIMIT)
    t = _k4_times(torch, ivf_rerank, ops, baseline)
    t_plain = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *ops), runs=3)
    one_bytes, _ = _k4_bytes(torch, vectors, queries[:1], pool[:1], coarse[:1], LIMIT)
    res = {"max_abs_err": err, "plain_ms": t_plain, "bound_ms": _bound_ms(nbytes), "bytes": nbytes,
           "distinct_rows": rows, "b1_bound_ms": _bound_ms(one_bytes), "route": ivf_rerank.route_of(vectors), **t}
    log(f"[k4-projected] K4 == plain at D={K4_PROJ_D} rr={K4_PROJ_RR} k={LIMIT} B={K4_PROJ_B} over "
        f"f32[{K4_PROJ_ROWS}, {K4_PROJ_D}] ({res['route']} route); max |err| {err:.3g}; {rows} distinct pool rows, "
        f"{nbytes} B")
    log("[k4-projected] " + _k4_line("K4", t, res["bound_ms"]) + f"; plain {t_plain:.4f} ms; B=1 bound "
        f"{res['b1_bound_ms']:.5f} ms")
    del vectors
    torch.cuda.empty_cache()
    return res


def phase_ivf_cell(torch, counted, argv=(), baseline=None) -> dict:
    """The bench cell through annbench.main, then K3 and K4 on the operands
    that one real search of the cell passes them."""
    from semadb_tpu_torch.ops.kernels import ivf_rerank, ivf_scan

    res, prof, launches, _, keep = _run_annbench(counted, argv, "ivf-cell")
    k5_routes = _k5_routes(counted)
    if res["recall@10"] < CELL_RECALL:
        raise AssertionError(f"the IVF cell's recall@10 {res['recall@10']} is below {CELL_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0 or launches["K5"] <= 0:
        raise AssertionError(f"the IVF cell did not run K3, K4 and K5 on the card: {launches}")
    if k5_routes.get("kernel", 0) <= 0 or any(r.startswith("library") for r in k5_routes):
        raise AssertionError(f"the IVF cell's probe selection left K5: {k5_routes}")
    log(f"[ivf-cell] launches during the cell's searches: {launches} (K3: one a call, "
        f"{len(ivf_scan.KERNELS)} kernels and a memset each); K5 by route {k5_routes}")

    # One more search of the cell, after the counts were read, hands over
    # the arguments it gives K3 and K4
    idx, test = keep["index"], keep["queries"]
    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, idx, test[: res["batch"]], "the cell")
    k3_ops, k4_ops, k3_bytes, t3 = kc["k3_ops"], kc["k4_ops"], kc["k3_bytes"], kc["t3"]
    qp, probe, q, pool_i, pool_d = k3_ops[0], k3_ops[1], k4_ops[1], k4_ops[2], k4_ops[3]
    B, p, S, r, rr, k, dedup = (kc[key] for key in ("B", "p", "S", "r", "rr", "k", "dedup"))
    err3, err4, t3_plain, t4_plain = kc["err3"], kc["err4"], kc["t3_plain"], kc["t4_plain"]
    distinct, live_distinct, valid = kc["distinct"], kc["live_distinct"], kc["valid"]
    k4_bytes, rows4 = kc["k4_bytes"], kc["rows4"]
    t4 = _k4_times(torch, ivf_rerank, k4_ops, baseline)
    # K4 by B (the cell's first B queries), and on its element route (the
    # same rows one float off the 16-byte grid): where its time goes
    k4_sweep = {}
    for b in K4_SWEEP_B:
        sub = (k4_ops[0], q[:b].contiguous(), pool_i[:b].contiguous(), pool_d[:b].contiguous()) + tuple(k4_ops[4:])
        k4_sweep[b] = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *sub), runs=IVF_TIMED_RUNS,
                                 kernel="rerank_kernel")
    offgrid = torch.empty(idx.vectors.numel() + 1, device=idx.vectors.device)[1:].view_as(idx.vectors)
    offgrid.copy_(idx.vectors)
    t4_element = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, offgrid, *k4_ops[1:]),
                            runs=IVF_TIMED_RUNS, kernel="rerank_kernel")
    del offgrid
    # K3 at smaller B (the cell's first B queries), device time per call, and
    # at B = 1 a call's time with its host launch work
    sweep = {}
    for b in K3_SWEEP_B:
        sub = (qp[:b].contiguous(), probe[:b].contiguous()) + tuple(k3_ops[2:])
        sweep[b] = _k3_device_ms(torch, ivf_scan, sub, 1, IVF_TIMED_RUNS)["ms"]
    one = (qp[:1].contiguous(), probe[:1].contiguous()) + tuple(k3_ops[2:])
    call1 = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *one))
    k3 = {"launches": launches["K3"], "max_abs_err": err3, "ms": t3["ms"], "plain_ms": t3_plain,
          "bound_ms": _bound_ms(k3_bytes["distinct"]), "bound_by": "bytes", "bytes": k3_bytes,
          "per_query_bound_ms": _bound_ms(k3_bytes["per_query_read"]),
          "design_bytes_ms": _bound_ms(k3_bytes["design"]), "distinct_clusters": distinct,
          "live_slots_distinct": live_distinct, "valid_slots": valid, "by_kernel_ms": t3["by_kernel_ms"],
          "kernels_per_call": t3["kernels_per_call"], "b_sweep_ms": sweep, "b1_call_ms": call1,
          "call_ms": kc["k3_call"], **{key: t3[key] for key in ("event_ms", "share", "measured_by")}}
    one_bytes, _ = _k4_bytes(torch, idx.vectors, q[:1], pool_i[:1], pool_d[:1], k)
    k4 = {"launches": launches["K4"], "max_abs_err": err4, "plain_ms": t4_plain, "dedup": dedup,
          "bound_ms": _bound_ms(k4_bytes), "bound_by": "bytes", "bytes": k4_bytes, "distinct_rows": rows4,
          "b1_bound_ms": _bound_ms(one_bytes), "route": ivf_rerank.route_of(idx.vectors), **t4,
          "b_sweep_ms": k4_sweep, "element_route_ms": t4_element}
    log(f"[ivf-cell] K3 == plain and K4 == plain on the cell's operands (B={B}, p={p}, S={S}, r={r}, rr={rr}, "
        f"{idx.slabs.dtype}, K4 dedup={dedup}); max |err| K3 {err3:.3g}, K4 {err4:.3g}")
    log(f"[ivf-cell] K3 {t3['ms']:.4f} ms a call, {t3['kernels_per_call']} device events a call, each one launch "
        f"a call (device, mean of {IVF_TIMED_RUNS}): "
        + _by_kernel_text(t3) + f"; the same calls by CUDA events {t3['event_ms']:.4f} ms a call (taken from the "
        f"{t3['measured_by']}); plain {t3_plain:.4f} ms; a call with its host work {kc['k3_call']:.4f} ms")
    log(f"[ivf-cell] K3 bound {k3['bound_ms']:.4f} ms by bytes ({k3_bytes['distinct']} B: {distinct} distinct "
        f"probed clusters once, the rows of their {live_distinct} live slots), {k3['bound_ms'] / t3['ms']:.1%} of "
        f"it; the design's own traffic (with the f32[{B}, {p}, {S}] scratch written and read) "
        f"{k3_bytes['design']} B = {k3['design_bytes_ms']:.4f} ms; what one block per query reads: "
        f"{k3_bytes['per_query_read']} B = {k3['per_query_bound_ms']:.4f} ms ({valid} live of {B * p * S} "
        f"probed slots; all slots {k3_bytes['per_query_all_slots']} B)")
    log("[ivf-cell] K3 by B (device ms a call, the cell's first B queries): "
        + "; ".join(f"B={b} {v:.4f}" for b, v in sweep.items())
        + f"; B=1 a call with its host launch work (median of 30) {call1:.4f} ms")
    log(f"[ivf-cell] K4 (dedup inside: {dedup}, {k4['route']} route) bound {k4['bound_ms']:.4f} ms by bytes "
        f"({k4_bytes} B: {rows4} distinct pool rows); B=1 bound {k4['b1_bound_ms']:.5f} ms; plain {t4_plain:.4f} ms")
    log("[ivf-cell] " + _k4_line("K4", t4, k4["bound_ms"]))
    log("[ivf-cell] K4 by B (device ms a call, the cell's first B queries): "
        + "; ".join(f"B={b} {v:.4f}" for b, v in k4_sweep.items())
        + f"; at B={B} on the element route (the rows off the 16-byte grid) {t4_element:.4f} ms")
    return {"res": res, "profile": prof, "k3": k3, "k4": k4, "k5": {"launches": launches["K5"], "by_route": k5_routes},
            "index": idx, "queries": test}


def _check_path_kernels(torch, ivf_scan, ivf_rerank, idx, queries, k: int, probes: int, what: str) -> dict:
    """K3 and K4 on the operands one real search of ``idx`` gives them (k and
    probes as the path asks; 0 probes = the engine's default), each held
    against its plain version: the operands (``k3_ops``, ``k4_ops``), the
    largest errors and the shape."""
    ops: dict = {}
    idx.search_batch_async(queries, k, probes, keep=ops)
    k3_ops, k4_ops = ops["k3"], ops["k4"]
    qp, slabs = k3_ops[0], k3_ops[2]
    q, pool_i = k4_ops[1], k4_ops[2]
    err3 = check_rows(torch, ivf_scan.ivf_probe_scan_plain(*k3_ops), ivf_scan.ivf_probe_scan(*k3_ops),
                      _k3_dist_of(torch, qp, slabs, idx.slab_sq, idx.slab_ids), _k3_atol(torch, qp, slabs),
                      f"K3 on {what}")
    err4 = check_rows(torch, ivf_rerank.ivf_exact_rerank_plain(*k4_ops), ivf_rerank.ivf_exact_rerank(*k4_ops),
                      _k4_dist_of(torch, idx.vectors, q, idx.metric),
                      _k4_atol(torch, idx.vectors[: 1 + int(pool_i.max())], q), f"K4 on {what}")
    shape = {"B": int(q.shape[0]), "p": int(k3_ops[1].shape[1]), "S": int(slabs.shape[1]), "r": int(slabs.shape[2]),
             "rr": int(k3_ops[6]), "k": int(k4_ops[4]), "D": int(q.shape[1])}
    log(f"[check] K3 == plain and K4 == plain on {what} ({shape}); max |err| K3 {err3:.3g}, K4 {err4:.3g}")
    return {"k3_ops": k3_ops, "k4_ops": k4_ops, "k3_err": err3, "k4_err": err4, "shape": shape}


def _cell_kernels(torch, ivf_scan, ivf_rerank, idx, queries, what: str) -> dict:
    """K3 and K4 on the operands one real search of ``idx`` gives them (a
    batch of ``queries``, through ``_ivf_query(keep=...)``): each checked
    against its plain version, K3 and both plain versions timed, and the
    bytes of each kernel's bound counted (K3: the ids of each distinct probed
    cluster once, the rows and norms of its live slots; K4: each distinct live
    pool row once). K3's profiler time is held to the CUDA-event time of the
    same calls (``_k3_device_ms``); ``k3_call`` is a call's time with its host
    work."""
    checked = _check_path_kernels(torch, ivf_scan, ivf_rerank, idx, queries, LIMIT, 0, what)
    k3_ops, k4_ops, err3, err4 = checked["k3_ops"], checked["k4_ops"], checked["k3_err"], checked["k4_err"]
    qp, probe, slabs, rr = k3_ops[0], k3_ops[1], k3_ops[2], k3_ops[6]
    q, pool_i, pool_d, k, dedup = k4_ops[1], k4_ops[2], k4_ops[3], k4_ops[4], k4_ops[6]
    p = probe.shape[1]
    B, S, r = q.shape[0], slabs.shape[1], slabs.shape[2]
    elem = slabs.element_size()
    probed = torch.unique(probe).long()
    distinct = int(probed.numel())
    # The least the function must read: every slot's id of each distinct
    # probed cluster once, and the row and norm of its live slots only
    live_distinct = int((idx.slab_ids[probed] != -1).sum())
    valid = int((idx.slab_ids[probe.long()] != -1).sum())
    io_bytes = B * r * 4 + B * p * 4 + B * rr * 8
    k3_bytes = {
        "distinct": distinct * S * 4 + live_distinct * (r * elem + 4) + io_bytes,
        "per_query_all_slots": B * p * S * (r * elem + 8) + io_bytes,
        "per_query_read": B * p * S * 4 + valid * (r * elem + 4) + io_bytes,
        # the design's own traffic: the distinct clusters, plus the
        # f32[B, p, S] scratch written once and read once
        "design": distinct * S * 4 + live_distinct * (r * elem + 4) + io_bytes + 2 * B * p * S * 4,
    }
    k4_bytes, rows4 = _k4_bytes(torch, idx.vectors, q, pool_i, pool_d, k)
    chunks = -(-B // ivf_scan.batch_chunk(B, p, S))
    k3_call = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *k3_ops))
    return {
        "k3_ops": k3_ops, "k4_ops": k4_ops, "B": B, "p": p, "S": S, "r": r, "rr": rr, "k": k, "dedup": dedup,
        "err3": err3, "err4": err4, "k3_bytes": k3_bytes, "k4_bytes": k4_bytes, "rows4": rows4,
        "distinct": distinct, "live_distinct": live_distinct, "valid": valid, "chunks": chunks,
        "t3": _k3_device_ms(torch, ivf_scan, k3_ops, chunks, IVF_TIMED_RUNS), "k3_call": k3_call,
        "t3_plain": _device_ms(torch, functools.partial(ivf_scan.ivf_probe_scan_plain, *k3_ops), runs=3),
        "t4_plain": _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *k4_ops), runs=3),
    }


def phase_ivf_http(torch, counted, device, seed: int, n_points: int = HTTP_IVF_POINTS) -> dict:
    """A vectorIVF collection over the port's node and HTTP v2 server."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like

    name = "ivf"
    schema = {"vector": {"type": "vectorIVF",
                         "vectorIVF": {"vectorSize": HTTP_IVF_DIM, "distanceMetric": "euclidean"}}}
    # The bench's generator and spread (embedding-like neighbour margins),
    # with held-out queries
    ds = embedding_like(n_points, HTTP_IVF_DIM, 10, spread=0.5, seed=seed + 11)
    data, queries = ds.train, ds.test
    rng = np.random.default_rng([seed, 11])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: i for i, pid in enumerate(ids)}
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_ivf_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            out = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema})
            assert out == {"message": "collection created"}, out
            col = srv.node.get_collection(bq.USER["X-User-Id"], name)
            col.user_plan = srv.plan
            t0 = time.perf_counter()
            for lo in range(0, n_points, 5000):
                pts = [Point.from_map({"vector": data[i].tolist()}, uuid.UUID(ids[i]))
                       for i in range(lo, min(lo + 5000, n_points))]
                failed = srv.node.insert_points(col, pts)
                assert failed == [], failed
            ingest_s = time.perf_counter() - t0
            hits, lat = 0, []
            for qv in queries:
                t1 = time.perf_counter()
                res = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": {
                    "property": "vector", "vectorIVF": {"vector": qv.tolist(), "operator": "near", "limit": 10}}})
                lat.append(time.perf_counter() - t1)
                d = ((data.astype(np.float64) - qv.astype(np.float64)) ** 2).sum(-1)
                truth = set(np.argsort(d)[:10].tolist())
                got = [row_of[p["_id"]] for p in res["points"]]
                hits += len(truth & set(got))
                for pnt, row in zip(res["points"], got):
                    if abs(pnt["_distance"] - d[row]) > 1e-4 * max(1.0, d[row]):
                        raise AssertionError(f"HTTP vectorIVF: distance {pnt['_distance']} of a point at {d[row]}")
        launches = {nm: mod.LAUNCHES for nm, mod in counted}
        k5_routes = _k5_routes(counted)
    recall = hits / 100
    log(f"[ivf-http] {n_points} points of {HTTP_IVF_DIM}-d into a vectorIVF collection through "
        f"ClusterNode.insert_points in {ingest_s:.2f} s; 10 HTTP searches: recall@10 {recall:.3f} against "
        f"numpy brute force, p50 {np.median(lat) * 1e3:.2f} ms; launches {launches}; K5 by route {k5_routes}")
    if recall < HTTP_IVF_RECALL:
        raise AssertionError(f"HTTP vectorIVF recall@10 {recall} is below {HTTP_IVF_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the HTTP vectorIVF searches did not run K3 and K4: {launches}")
    return {"recall": recall, "launches": launches, "k5_by_route": k5_routes}


def phase_wide_filter(torch, counted, idx, queries, seed: int) -> dict:
    """The widened-probe path at scale, on the bench cell's index: a seeded
    random filter over half the points is wider than FILTER_EXACT_CAP, so
    the search probes FILTER_WIDEN times as many clusters and K3 skips the
    masked slots. Recall@10 against numpy's exact search over the members."""
    from semadb_tpu_torch.index.ivf import FILTER_EXACT_CAP, FILTER_WIDEN

    ids = np.fromiter(idx._loc.keys(), np.int64, len(idx._loc))
    rng = np.random.default_rng([seed, 33])
    fm = np.zeros(idx.capacity, bool)
    fm[ids[rng.random(len(ids)) < WIDE_FILTER_SHARE]] = True
    members = np.nonzero(fm)[0]
    if len(members) <= max(idx._num_probes() * idx.slab, FILTER_EXACT_CAP):
        raise AssertionError(f"{len(members)} members take the exact member path, not the widened probes")
    q = np.ascontiguousarray(queries[:WIDE_QUERIES], np.float32)
    _zero_counts(counted)
    t0 = time.perf_counter()
    _, got = idx.search_batch(q, LIMIT, filter_mask=fm)
    search_s = time.perf_counter() - t0
    launches = {nm: mod.LAUNCHES for nm, mod in counted}
    k5_routes = _k5_routes(counted)
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the widened-probe search did not run K3 and K4: {launches}")
    # numpy: f32 scores over the members, then the best 64 of each query in f64
    x = idx.vectors[torch.from_numpy(members).to(idx.device)].cpu().numpy()
    xx = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    hits = 0
    for lo in range(0, len(q), 64):
        qs = q[lo:lo + 64]
        cand = np.argpartition(xx[:, None] - 2.0 * (x @ qs.T), 64, axis=0)[:64].T
        for b, rows in enumerate(cand):
            d = ((x[rows].astype(np.float64) - qs[b].astype(np.float64)) ** 2).sum(1)
            truth = set(members[rows[np.argsort(d, kind="stable")[:LIMIT]]].tolist())
            hits += len(truth & set(got[lo + b].tolist()))
    recall = hits / (LIMIT * len(q))
    p = idx._num_probes()
    log(f"[wide-filter] {len(members)} of {len(ids)} points in the filter (> FILTER_EXACT_CAP {FILTER_EXACT_CAP}): "
        f"{len(q)} queries with p = {min(FILTER_WIDEN * p, idx.centroids.shape[0])} probes ({FILTER_WIDEN} x {p}) "
        f"in {search_s * 1e3:.1f} ms; recall@10 {recall:.4f} against numpy's exact search over the members; "
        f"launches {launches}; K5 by route {k5_routes}")
    if recall < WIDE_RECALL:
        raise AssertionError(f"widened-probe recall@10 {recall} is below {WIDE_RECALL}")
    return {"recall": recall, "launches": launches, "k5_by_route": k5_routes, "members": int(len(members))}


CELL_10M_ARGV = ("--n", "10000000", "--sweep", "48,96")
CELL_10M_RECALL = 0.97  # the JAX package read 0.9790 on this configuration
WRITE_POINTS = 10_000
WRITE_SEED = 43  # the cell's generator is seeded 42


def _k3_line(t3, nbytes) -> str:
    return (f"{t3['ms']:.4f} ms a call ({_bound_ms(nbytes) / t3['ms']:.1%} of the {_bound_ms(nbytes):.4f} ms bound, "
            f"{nbytes} B), from the {t3['measured_by']} (the same calls by CUDA events {t3['event_ms']:.4f} ms): "
            + _by_kernel_text(t3))


def phase_ivf_10m(torch, counted, argv=CELL_10M_ARGV) -> dict:
    """Phase 10: ``BENCH_N=10000000 python bench.py`` on the port, through
    ``annbench.main`` (the device generator, the two-level refit, the sweep);
    then K3 and K4 on the cell's own operands, K3 and the recall on f32 slabs
    rebuilt from the same ``slab_ids``, and two write transactions of
    WRITE_POINTS new points each through the two-level assignment."""
    from semadb_tpu_torch.index import ivf
    from semadb_tpu_torch.ops.kernels import ivf_rerank, ivf_scan
    from semadb_tpu_torch.tools.datasets import embedding_like_device

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, prof, launches, _, keep = _run_annbench(counted, argv, "ivf-10m")
    k5_routes = _k5_routes(counted)
    cell_s = time.perf_counter() - t0
    idx, test, bench, gt = keep["index"], keep["queries"], keep["bench"], keep["ground_truth"]
    n, batch = res["n"], res["batch"]
    # What the refit should choose, by the code: C from the automatic count,
    # S from _auto_slab, bf16 past SLAB_BF16_BYTES
    want_c = ivf._npow2(max(n // ivf.TARGET_CLUSTER_SIZE, 1), 16, 131072)
    want_s = ivf._auto_slab(min(2, want_c), n, want_c, idx.tdim, ivf.DEFAULT_SLAB * 2)
    want_dtype = "bfloat16" if want_c * want_s * idx.tdim * 4 > ivf.SLAB_BF16_BYTES else "float32"
    got = (res["clusters"], res["slab"], res["slab_dtype"], res["two_level"])
    want = (want_c, want_s, want_dtype, want_c >= ivf.TWO_LEVEL_MIN_C)
    log(f"[ivf-10m] C, S, slab dtype, two-level: {got} (the code predicts {want}); super layer "
        f"{None if idx._sup_cents is None else tuple(idx._sup_cents.shape)}; {cell_s:.1f} s for annbench.main")
    if got != want or idx._sup_cents is None:
        raise AssertionError(f"the 10M cell's refit chose {got}, not {want}")
    if res["recall@10"] < CELL_10M_RECALL:
        raise AssertionError(f"the 10M cell's recall@10 {res['recall@10']} is below {CELL_10M_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the 10M cell did not run K3 and K4 on the card: {launches}")
    if not res["sweep"]:
        raise AssertionError("the 10M cell printed no sweep rows")
    for row in res["sweep"]:
        log(f"[ivf-10m] sweep: p={row['probes']} recall@10 {row['recall@10']:.4f} eps-recall "
            f"{row['recall_eps@10']:.4f} QPS {row['qps']:.1f} (of 2 passes: {row['qps_spread']})")
    log(f"[ivf-10m] launches during the cell's fit and searches: {launches}; K5 by route {k5_routes}")

    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, idx, test[:batch], "the 10M cell")
    k3_ops, k4_ops, k3_bytes, k3_call = kc["k3_ops"], kc["k4_ops"], kc["k3_bytes"], kc["k3_call"]
    t4 = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *k4_ops), runs=IVF_TIMED_RUNS,
                    kernel="rerank_kernel")
    log(f"[ivf-10m] K3 == plain and K4 == plain on the cell's operands (B={kc['B']}, p={kc['p']}, S={kc['S']}, "
        f"r={kc['r']}, rr={kc['rr']}, {idx.slabs.dtype}); max |err| K3 {kc['err3']:.3g}, K4 {kc['err4']:.3g}")
    log(f"[ivf-10m] K3 {_k3_line(kc['t3'], k3_bytes['distinct'])}; {kc['distinct']} distinct probed clusters, "
        f"{kc['live_distinct']} live slots in them; a call with its host work (median of 30, CUDA events) "
        f"{k3_call:.4f} ms; plain {kc['t3_plain']:.4f} ms")
    log(f"[ivf-10m] K4 {t4:.4f} ms a call ({_bound_ms(kc['k4_bytes']) / t4:.1%} of the "
        f"{_bound_ms(kc['k4_bytes']):.4f} ms bound, {kc['k4_bytes']} B: {kc['rows4']} distinct pool rows); "
        f"plain {kc['t4_plain']:.4f} ms")

    # The same slab_ids in f32 (no new k-means): K3 on both slab types, and
    # the recall and QPS f32 slabs would give
    t0 = time.perf_counter()
    slabs32, _ = ivf._slabs_from_ids(idx.vectors, idx.slab_ids, idx._proj, out_dtype=torch.float32, want_sq=False)
    torch.cuda.synchronize()
    f32_build_s = time.perf_counter() - t0
    ops32 = (k3_ops[0], k3_ops[1], slabs32) + tuple(k3_ops[3:])
    err32 = check_rows(torch, ivf_scan.ivf_probe_scan_plain(*ops32), ivf_scan.ivf_probe_scan(*ops32),
                       _k3_dist_of(torch, k3_ops[0], slabs32, idx.slab_sq, idx.slab_ids),
                       _k3_atol(torch, k3_ops[0], slabs32), "K3 on the 10M cell, f32 slabs")
    call32 = _median_call_ms(torch, functools.partial(ivf_scan.ivf_probe_scan, *ops32))
    t3_32 = _k3_device_ms(torch, ivf_scan, ops32, kc["chunks"], IVF_TIMED_RUNS)
    bytes32 = k3_bytes["distinct"] + kc["live_distinct"] * kc["r"] * 2  # 4 B a value where bf16 has 2
    peak_f32 = torch.cuda.max_memory_allocated() / 2**30
    bf16 = idx.slabs
    with idx._state_lock:
        idx.slabs = slabs32
    try:
        passes = [bench.query_batch(test, LIMIT, batch) for _ in range(2)]
    finally:
        with idx._state_lock:
            idx.slabs = bf16
    ids32, wall32 = min(passes, key=lambda pw: pw[1])
    recall32 = float(np.mean([len(set(ids32[i]) & set(gt[i])) / LIMIT for i in range(len(gt))]))
    del slabs32, ops32, passes
    torch.cuda.empty_cache()
    log(f"[ivf-10m] f32 slabs from the same slab_ids ({f32_build_s:.2f} s, peak device memory then "
        f"{peak_f32:.2f} GiB): K3 == plain, max |err| {err32:.3g}; K3 {_k3_line(t3_32, bytes32)}; a call with "
        f"its host work (median of 30, CUDA events) {call32:.4f} ms; recall@10 "
        f"{recall32:.4f} (bf16 {res['recall@10']:.4f}), QPS {len(gt) / wall32:.1f} (bf16 {res['qps']:.1f}, best of "
        f"2 against best of 3)")

    # Two write transactions after the fit, of new ids past the corpus:
    # held-out rows of the corpus's own mixture (the cell's last queries), then
    # rows the cell's generator draws with another seed. Each goes through the
    # two-level assignment and the write repair; every point must come back as
    # its own nearest neighbour
    batches = {
        "held-out rows of the corpus's mixture": test[-WRITE_POINTS:].cpu().numpy(),
        f"rows of another mixture (seed {WRITE_SEED})": embedding_like_device(
            WRITE_POINTS, idx.params.vector_size, 1, spread=0.5, seed=WRITE_SEED, device=idx.device
        ).train.cpu().numpy(),
    }
    writes, next_id = {}, n + 2
    k5_before = dict(dict(counted)["K5"].LAUNCHES_BY)
    for what, new in batches.items():
        w = _write_after_fit(ivf, idx, new, np.arange(next_id, next_id + len(new)))
        next_id += len(new)
        writes[what] = w
        log(f"[ivf-10m] write transaction of {len(new)} {what}: {w['write_s']:.3f} s, of which the two-level "
            f"assignment {w['assign_s']:.3f} s ({w['two_level_assignments']} call(s)) and the repair "
            f"{w['repair_s']:.3f} s; rows the repair placed by their own probes {w['repaired']}; refit {w['refit']}; "
            f"{len(new) - w['lost']} of {len(new)} come back as their own nearest neighbour")
        if w["lost"] or not w["two_level_assignments"] or w["refit"]:
            raise AssertionError(f"the write of {what} after the 10M fit: {w}")
    # Write placement probes Cn // 170 clusters a row, past K5's cap at this C
    k5_write_routes = _k5_routes(counted, k5_before)
    log(f"[ivf-10m] K5 by route over the two write transactions: {k5_write_routes}")
    log(f"[ivf-10m] peak device memory over the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    k3 = {"launches": launches["K3"], "max_abs_err": max(kc["err3"], err32), "ms": kc["t3"]["ms"],
          "plain_ms": kc["t3_plain"], "bound_ms": _bound_ms(k3_bytes["distinct"]), "bytes": k3_bytes,
          "by_kernel_ms": kc["t3"]["by_kernel_ms"], "distinct_clusters": kc["distinct"],
          "live_slots_distinct": kc["live_distinct"], "call_ms": k3_call, "f32_ms": t3_32["ms"], "f32_call_ms": call32,
          **{key: kc["t3"][key] for key in ("event_ms", "share", "measured_by")},
          "f32_bound_ms": _bound_ms(bytes32)}
    k4 = {"launches": launches["K4"], "max_abs_err": kc["err4"], "ms": t4, "plain_ms": kc["t4_plain"],
          "bound_ms": _bound_ms(kc["k4_bytes"]), "bytes": kc["k4_bytes"], "distinct_rows": kc["rows4"]}
    k5 = {"launches": launches["K5"], "by_route": k5_routes, "writes_by_route": k5_write_routes}
    return {"res": res, "profile": prof, "k3": k3, "k4": k4, "k5": k5, "recall_f32": recall32,
            "qps_f32": len(gt) / wall32, "writes": writes, "cell_s": cell_s}


def _write_after_fit(ivf, idx, new, new_ids) -> dict:
    """One write transaction of ``new`` under ``new_ids`` into a fitted
    two-level index: its seconds, the seconds of the assignment and of the
    repair (``_within_own_probes``) inside it (each returns host arrays, so
    each has waited for its device work), the rows the repair moved, and the
    points that do not come back as their own nearest neighbour."""
    spent = {"assign_s": 0.0, "repair_s": 0.0}
    reached = []

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    assign = ivf.kmeans_assign_two_level
    ivf.kmeans_assign_two_level = lambda *a, **kw: reached.append(1) or assign(*a, **kw)
    idx._assign_top = timed(idx._assign_top, "assign_s")
    idx._within_own_probes = timed(idx._within_own_probes, "repair_s")
    repaired, n_fit = idx.repaired_writes, idx._n_at_fit
    try:
        t0 = time.perf_counter()
        idx.insert_update_delete(zip(new_ids.tolist(), new))
        idx.sync()
        write_s = time.perf_counter() - t0
    finally:
        ivf.kmeans_assign_two_level = assign
        del idx._assign_top, idx._within_own_probes
    _, found = idx.search_batch(new, 1)
    return {"write_s": write_s, **spent, "two_level_assignments": len(reached),
            "repaired": idx.repaired_writes - repaired, "lost": int((found[:, 0] != new_ids).sum()),
            "refit": idx._n_at_fit != n_fit}


def load_k4_baseline(source: str):
    """Build and load another K4 source with the same C interface (e.g. the
    parent commit's ``csrc/ivf_rerank.cu``, its ``ivf_common.cuh`` beside it),
    to time beside the tree's K4; it launches through ``ivf_rerank.launch``
    and counts nothing."""
    import os

    from semadb_tpu_torch.ops.kernels import ivf_rerank
    from semadb_tpu_torch.utils.build import NVCC_FLAGS, build_library, nvcc

    header = os.path.join(os.path.dirname(os.path.abspath(source)), "ivf_common.cuh")
    path, _ = build_library("ivf_rerank_baseline", source, nvcc(), NVCC_FLAGS, (header,))
    log(f"[build] K4 baseline {source}: built into {path}")
    return ivf_rerank.bind(path)


def load_k9_baseline(source: str):
    """Build and load another K9 source with the same C interface (e.g. the
    parent commit's ``csrc/ivf_pq_scan.cu``, with the ``ivf_common.cuh`` beside
    it when there is one), to time beside the tree's K9; it launches through
    :func:`_k9_baseline_call` and counts nothing."""
    import os

    from semadb_tpu_torch.ops.kernels import ivf_pq_scan
    from semadb_tpu_torch.utils.build import NVCC_FLAGS, build_library, nvcc

    header = os.path.join(os.path.dirname(os.path.abspath(source)), "ivf_common.cuh")
    path, _ = build_library("ivf_pq_scan_baseline", source, nvcc(), NVCC_FLAGS,
                            (header,) if os.path.exists(header) else ())
    log(f"[build] K9 baseline {source}: built into {path}")
    return ivf_pq_scan.bind(path)


def _k9_baseline_call(ivf_pq_scan, lib, table, probe, codes, ids, mask, rr):
    """The K9 baseline's probed entry on the tree's operands. The baseline
    source this flag was written for (the one-query-a-block design with a
    bitonic-sorted append buffer) takes, after rr, the length of that
    buffer: the power of two at or above rr + 1,024 (and at least 1,024)."""
    nbuf = 1024
    while nbuf < rr + 1024:
        nbuf <<= 1
    return ivf_pq_scan.launch_probed(lib, table, probe, codes, ids, mask, rr, nbuf)


def hybrid_corpus(n: int, seed: int) -> dict:
    """Phase 9's documents, from ``seed`` with numpy: vectors from
    ``embedding_like(spread=0.5)`` (and held-out queries); ``body`` 12 terms
    ``w<rank>``, Zipf over the vocabulary as the text bench draws them;
    ``category`` one of 20, Zipf-skewed; ``year`` uniform over 1990-2024;
    ``tags`` 1-3 distinct of 50."""
    import uuid

    from semadb_tpu_torch.tools.datasets import embedding_like

    ds = embedding_like(n, HYBRID_DIM, HYBRID_QUERIES, spread=0.5, seed=seed + 31)
    rng = np.random.default_rng([seed, 31])
    ranks = np.minimum(rng.zipf(HYBRID_ZIPF, size=(n, HYBRID_TERMS)) - 1, HYBRID_VOCAB - 1)
    p = 1.0 / np.arange(1, HYBRID_CATEGORIES + 1) ** HYBRID_CATEGORY_ZIPF
    category = rng.choice(HYBRID_CATEGORIES, size=n, p=p / p.sum())
    year = rng.integers(HYBRID_YEARS[0], HYBRID_YEARS[1] + 1, size=n)
    n_tags = rng.integers(1, 4, size=n)
    tag_order = np.argsort(rng.random((n, HYBRID_TAGS)), axis=1)[:, :3]
    tags = np.zeros((n, HYBRID_TAGS), bool)
    for j in range(3):
        rows = np.nonzero(n_tags > j)[0]
        tags[rows, tag_order[rows, j]] = True
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n)]
    return {"vectors": ds.train, "queries": ds.test, "ranks": ranks, "category": category, "year": year,
            "tags": tags, "ids": ids, "row_of": {pid: i for i, pid in enumerate(ids)}}


def _hybrid_doc(c: dict, i: int) -> dict:
    return {"vector": c["vectors"][i].tolist(),
            "body": " ".join(f"w{r}" for r in c["ranks"][i]),
            "category": f"c{c['category'][i]:02d}", "year": int(c["year"][i]),
            "tags": [f"t{j:02d}" for j in np.nonzero(c["tags"][i])[0]]}


def _text_scores(c: dict, terms) -> tuple:
    """Each document's TF-IDF score for the query terms (``index/text.py``:
    Σ over the terms of count / length · log10(N / (df + 1))), and which
    documents hold each term."""
    ranks = c["ranks"]
    n = len(ranks)
    counts = np.stack([(ranks == t).sum(1) for t in terms])
    df = (counts > 0).sum(1)
    score = (counts / HYBRID_TERMS * np.log10(n / (df + 1))[:, None]).sum(0)
    return score, counts > 0


def phase_hybrid(torch, counted, device, seed: int, n_points: int = HYBRID_POINTS) -> dict:
    """A hybrid collection over HTTP v2: a vectorIVF property beside text,
    string, integer and stringArray ones, every query checked against a
    plain evaluation over the generated documents."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.models.query import Query
    from semadb_tpu_torch.ops.topk import tie_rule_errors
    from semadb_tpu_torch.shard import pointstore
    from semadb_tpu_torch.tools import dbpedia_bq as bq

    name = "hybrid"
    schema = {"vector": {"type": "vectorIVF", "vectorIVF": {"vectorSize": HYBRID_DIM, "distanceMetric": "euclidean"}},
              "body": {"type": "text", "text": {"analyser": "standard"}},
              "category": {"type": "string", "string": {"caseSensitive": False}},
              "year": {"type": "integer", "integer": {}},
              "tags": {"type": "stringArray", "stringArray": {"caseSensitive": False}}}
    t0 = time.perf_counter()
    c = hybrid_corpus(n_points, seed)
    gen_s = time.perf_counter() - t0
    data = c["vectors"].astype(np.float64)
    row_of = c["row_of"]
    lat: dict = {}
    checked: dict = {}

    def search(query, limit=10, kind=None):
        t1 = time.perf_counter()
        res = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": query, "limit": limit})
        if kind is not None:
            lat.setdefault(kind, []).append(time.perf_counter() - t1)
            checked[kind] = checked.get(kind, 0) + 1
        return res["points"]

    def members_of(query):
        """Every point of a set query, as the shard's index manager finds it
        (node ids to point ids through the shard's point store)."""
        def on_shard(shard):
            out = []

            def reader(bm):
                nodes = sorted(shard._index_manager(bm).search(Query.from_dict(query))[0])
                out.extend(shard._uuid_strs.lookup(bm.get(pointstore.POINTS_BUCKET_NAME), nodes))

            shard.db.read(reader)
            return out

        return [row_of[pid] for pid in srv.node.shard_manager.do_with_shard(col, col.shard_ids[0], on_shard)]

    def near(q, flt=None, limit=10):
        body = {"vector": q.tolist(), "operator": "near", "limit": limit}
        if flt is not None:
            body["filter"] = flt
        return {"property": "vector", "vectorIVF": body}

    cat, year, tags = c["category"], c["year"], c["tags"]
    counts = np.bincount(cat, minlength=HYBRID_CATEGORIES)
    rare, common = int(np.argmin(counts)), int(np.argmax(counts))
    ta, tb = 3, 17
    filters = [  # (kind, query, the members as a mask over the documents)
        ("string equals, rare", {"property": "category", "string": {"value": f"c{rare:02d}", "operator": "equals"}},
         cat == rare),
        ("string equals, common", {"property": "category", "string": {"value": f"c{common:02d}",
                                                                      "operator": "equals"}}, cat == common),
        ("integer inRange", {"property": "year", "integer": {"value": 2003, "endValue": 2004, "operator": "inRange"}},
         (year >= 2003) & (year <= 2004)),
        ("integer greaterThanOrEquals", {"property": "year", "integer": {"value": 2024,
                                                                         "operator": "greaterThanOrEquals"}},
         year >= 2024),
        ("stringArray containsAny", {"property": "tags", "stringArray": {"value": [f"t{ta:02d}", f"t{tb:02d}"],
                                                                          "operator": "containsAny"}},
         tags[:, [ta, tb]].any(1)),
        ("stringArray containsAll", {"property": "tags", "stringArray": {"value": [f"t{ta:02d}", f"t{tb:02d}"],
                                                                          "operator": "containsAll"}},
         tags[:, [ta, tb]].all(1)),
    ]
    rng = np.random.default_rng([seed, 32])
    mid = rng.integers(100, 1000, size=(4, 2))
    text_queries = ([("common", op, [a, b]) for op in ("containsAny", "containsAll") for a, b in ((0, 4), (1, 6))]
                    + [("mid", op, [int(a), int(b)]) for op in ("containsAny", "containsAll") for a, b in mid])

    with tempfile.TemporaryDirectory(prefix="semadb_smoke_hybrid_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            # one shard on the one device, so every search is exact over the collection
            out = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema, "shardPlacement": "device"})
            assert out == {"message": "collection created"}, out
            col = srv.node.get_collection(bq.USER["X-User-Id"], name)
            col.user_plan = srv.plan
            t0 = time.perf_counter()
            for lo in range(0, n_points, HYBRID_BATCH):
                pts = [Point.from_map(_hybrid_doc(c, i), uuid.UUID(c["ids"][i]))
                       for i in range(lo, min(lo + HYBRID_BATCH, n_points))]
                failed = srv.node.insert_points(col, pts)
                assert failed == [], failed
            ingest_s = time.perf_counter() - t0
            assert len(col.shard_ids) == 1, col.shard_ids

            # Set queries: the first page over HTTP, the whole set on the shard
            for kind, query, mask in filters:
                want = set(np.nonzero(mask)[0].tolist())
                page = [row_of[p["_id"]] for p in search(query, HYBRID_PAGE, kind=kind)]
                if len(page) != min(HYBRID_PAGE, len(want)) or not set(page) <= want:
                    raise AssertionError(f"{kind}: a page of {len(page)} points, {len(set(page) - want)} not in "
                                         f"the {len(want)} the documents give")
                got = members_of(query)
                if len(got) != len(set(got)) or set(got) != want:
                    raise AssertionError(f"{kind}: {len(set(got))} points ({len(got)} with repeats), the "
                                         f"documents give {len(want)}; {len(set(got) ^ want)} differ")

            # vectorIVF filtered by each: numpy's brute force over the members
            for kind, query, mask in filters:
                members = np.nonzero(mask)[0]
                for q in c["queries"]:
                    pts = search(near(q, query), kind=f"vectorIVF filtered by {kind}")
                    d = ((data[members] - q.astype(np.float64)) ** 2).sum(-1)
                    order = np.argsort(d, kind="stable")[:10]
                    dist = dict(zip(members.tolist(), d.tolist()))
                    got_rows = [row_of[p["_id"]] for p in pts]
                    atol = IVF_RTOL * ((np.sqrt(d.max()) + 2 * float(np.linalg.norm(q))) ** 2 + 1.0)
                    errs = tie_rule_errors(d[order], members[order].tolist(), [p["_distance"] for p in pts],
                                           got_rows, lambda r: dist.get(r, float("inf")), atol=atol)
                    if errs:
                        raise AssertionError(f"vectorIVF filtered by {kind}: {errs[:3]}")

            # Text: scores by the formula, ids by the tie rule
            for tag, op, terms in text_queries:
                kind = f"text {op}, {tag} terms"
                value = " ".join(f"w{t}" for t in terms)
                pts = search({"property": "body", "text": {"value": value, "operator": op, "limit": 10}}, kind=kind)
                score, has = _text_scores(c, terms)
                sel = np.nonzero(has.all(0) if op == "containsAll" else has.any(0))[0]
                order = sel[np.argsort(-score[sel], kind="stable")[:10]]
                got_rows = [row_of[p["_id"]] for p in pts]
                got_s = [p["_score"] for p in pts]
                if any(not (has[:, r].all() if op == "containsAll" else has[:, r].any()) for r in got_rows):
                    raise AssertionError(f"{kind}: a result does not hold the terms {value}")
                if any(a < b for a, b in zip(got_s, got_s[1:])):
                    raise AssertionError(f"{kind}: scores not descending: {got_s}")
                atol = TEXT_RTOL * max(1e-12, float(score.max()))
                errs = tie_rule_errors((-score[order]).tolist(), order.tolist(), [-x for x in got_s], got_rows,
                                       lambda r: -score[r], atol=atol)
                if errs:
                    raise AssertionError(f"{kind} ({value}): {errs[:3]}")

            # Hybrid: an unfiltered vectorIVF arm (weight 1) or a text arm (weight 0.5)
            k3_before, k4_before = (mod.LAUNCHES for nm, mod in counted if nm in ("K3", "K4"))
            for i, q in enumerate(c["queries"]):
                terms = [int(t) for t in mid[i % len(mid)]]
                text = {"property": "body", "text": {"value": " ".join(f"w{t}" for t in terms),
                                                     "operator": "containsAny", "limit": 10, "weight": 0.5}}
                vec = near(q)
                vec["vectorIVF"]["weight"] = 1.0
                alone_v = {p["_id"]: p["_distance"] for p in search(vec)}
                alone_t = {p["_id"]: p["_score"] for p in search(text)}
                pts = search({"property": "_or", "_or": [vec, text]}, limit=20, kind="hybrid _or")
                if {p["_id"] for p in pts} != set(alone_v) | set(alone_t):
                    raise AssertionError("hybrid _or: the points are not the union of its arms")
                hs = [p["_hybridScore"] for p in pts]
                if any(a < b for a, b in zip(hs, hs[1:])):
                    raise AssertionError(f"hybrid _or: hybrid scores not descending: {hs}")
                for p in pts:
                    want = -alone_v.get(p["_id"], 0.0) * 1.0 + alone_t.get(p["_id"], 0.0) * 0.5
                    if abs(p["_hybridScore"] - want) > 1e-5 * max(1.0, abs(want)):
                        raise AssertionError(f"hybrid _or: {p['_hybridScore']} != {want}")
            launches = {nm: mod.LAUNCHES for nm, mod in counted}
            if launches["K3"] <= k3_before or launches["K4"] <= k4_before:
                raise AssertionError(f"the hybrid searches did not run K3 and K4: {launches}")

            # The exact member scan (K8, plain torch) at the common category:
            # its node ids from the shard's own inverted index
            def members_and_index(shard):
                out = []
                shard.db.read(lambda bm: out.append(shard._index_manager(bm).search(
                    Query.from_dict(filters[1][1]))[0]))
                return out[0], shard.device_indices["index/vectorIVF/vector"]

            nodes, idx = srv.node.shard_manager.do_with_shard(col, col.shard_ids[0], members_and_index)
            fm = np.zeros(idx.capacity, bool)
            fm[np.fromiter(nodes, np.int64, len(nodes))] = True
            scan = functools.partial(idx.search_batch_async, c["queries"][:1], 10, filter_mask=fm)
            member_ms = _device_ms(torch, scan, runs=IVF_TIMED_RUNS)
            member_call_ms = _median_call_ms(torch, scan)
    p50 = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
    log(f"[hybrid] {n_points} points (vectorIVF {HYBRID_DIM}-d, text, string, integer, stringArray) made in "
        f"{gen_s:.2f} s, ingested through ClusterNode.insert_points {HYBRID_BATCH} a txn in {ingest_s:.2f} s = "
        f"{n_points / ingest_s:.1f} points/s; one shard; category sizes rare {counts[rare]}, common {counts[common]}")
    log(f"[hybrid] every check passed: {json.dumps(checked)}")
    log("[hybrid] p50 ms over HTTP by kind: " + "; ".join(f"{k} {v:.2f}" for k, v in p50.items()))
    log(f"[hybrid] the exact member scan over {int(fm.sum())} members (the common category): {member_ms:.4f} ms "
        f"of device time a call, {member_call_ms:.4f} ms a call; launches in this phase {launches}")
    return {"ingest_rate": n_points / ingest_s, "p50_ms": p50, "member_ms": member_ms,
            "member_call_ms": member_call_ms, "launches": launches, "checked": checked}


def _k9_operands(torch, gen, b, p, s, m, k, masked, device, layout=None):
    """A code slab set for K9 at a shape: u8[c, s, m] codes, distinct ids from
    2 on with 30% NIL slots, normal f32 tables, p distinct probes a query and
    a u8 mask that admits about half the ids; ``layout`` as K9_LAYOUT_CASES
    says."""
    c = max(2 * p, 32)
    codes = torch.randint(0, k, (c, s, m), generator=gen, dtype=torch.uint8)
    ids = (torch.randperm(c * s, generator=gen).reshape(c, s) + 2).to(torch.int32)
    ids[torch.rand((c, s), generator=gen) < (0.85 if layout == "sparse" else 0.3)] = -1
    if layout == "all-nil":
        ids[torch.rand(c, generator=gen) < 0.5] = -1
    elif layout == "nil":
        ids[:] = -1
    table = torch.randn((b, m, k), generator=gen)
    if layout == "ties":
        table = torch.randint(-2, 3, (b, m, k), generator=gen).float()
    elif layout == "negative":
        table = -1.0 - table.abs()
    probe = torch.argsort(torch.rand((b, c), generator=gen), dim=1)[:, :p].to(torch.int32)
    if layout == "dup-probes" and p >= 4:  # a cluster twice, then -1 and C
        probe[:, 1] = probe[:, 0]
        probe[:, 2] = -1
        probe[:, 3] = c
    mask = (torch.rand(c * s + 2, generator=gen) < 0.5).to(torch.uint8) if masked else None
    return [None if t is None else t.to(device) for t in (table, probe.contiguous(), codes, ids, mask)]


def _k9_dist_of(torch, table, codes, slab_ids):
    """id → its ADC score for query b, in f64 on the host (first copy of the
    id), from host copies of the operands made at the first lookup."""
    index = {}
    m = codes.shape[-1]

    def dist_of(b, i):
        if not index:
            ids_h = slab_ids.cpu().numpy().reshape(-1)
            index["order"] = np.argsort(ids_h, kind="stable")
            index["sorted"] = ids_h[index["order"]]
            index["codes"] = codes.reshape(-1, m).cpu().numpy().astype(np.int64)
            index["table"] = table.cpu().double().numpy()
        cell = int(index["order"][np.searchsorted(index["sorted"], i)])
        return float(index["table"][b][np.arange(m), index["codes"][cell]].sum())

    return dist_of


def _k9_atol(torch, table):
    """Per query: IVF_RTOL x M x max|table|, the size of the summed terms."""
    return (IVF_RTOL * table.shape[1] * table.abs().amax(dim=(1, 2)).double()).cpu()


def _k9_bytes(torch, probe, slab_ids, m, k, rr) -> dict:
    """The least bytes of one probed K9 call: each distinct probed cluster's
    ids once and the codes of its live slots once, the probe list, each
    query's table once, the pool written once."""
    b, p = probe.shape
    s = slab_ids.shape[1]
    probed = torch.unique(probe).long()
    live = int((slab_ids[probed] != -1).sum())
    return {"bytes": int(probed.numel()) * s * 4 + live * m + b * p * 4 + b * m * k * 4 + b * rr * 8,
            "distinct_clusters": int(probed.numel()), "live_slots_distinct": live}


def _k9_dense_bytes(table, codes, mask) -> int:
    """The least bytes of one dense K9 call: the codes of the rows the mask
    admits, the mask, each table once, the scores written once."""
    b, m, k = table.shape
    n = codes.shape[0]
    live = n if mask is None else int(mask.sum())
    return live * m + (0 if mask is None else n) + b * m * k * 4 + b * n * 4


def _check_k9(torch, ivf_pq_scan, ops, rr, what, fn=None) -> float:
    """K9's probed entry (or ``fn``) against its plain version on ``ops``:
    scores within _k9_atol, pools by the tie rule, and exactly min(rr, live)
    places filled, each with an id. Returns the largest |error|."""
    table, probe, codes, ids, mask = ops
    got = (fn or ivf_pq_scan.ivf_pq_probe_scan)(table, probe, codes, ids, mask, rr)
    torch.cuda.synchronize()
    want = ivf_pq_scan.ivf_pq_probe_scan_plain(table, probe, codes, ids, mask, rr)
    if not torch.equal(got[1] >= 0, torch.isfinite(got[0])):
        raise AssertionError(f"{what}: a filled place without an id, or an id at an unfilled one")
    return check_rows(torch, want, got, _k9_dist_of(torch, table, codes, ids), _k9_atol(torch, table), what)


def phase_pq_kernels(torch, ivf_pq_scan, device) -> dict:
    """K9's two entries against their plain versions at every listed shape."""
    gen = torch.Generator().manual_seed(1357)
    worst = worst_d = 0.0
    for b, p, s, m, k, rr, masked in K9_CASES:
        ops = _k9_operands(torch, gen, b, p, s, m, k, masked, device)
        worst = max(worst, _check_k9(torch, ivf_pq_scan, ops, rr,
                                     f"K9 probed B={b} p={p} S={s} M={m} K={k} rr={rr} mask={masked}"))
    chunk = ivf_pq_scan.CHUNK
    for b, p, s, m, k, rr, masked, layout, ch in K9_LAYOUT_CASES:
        ops = _k9_operands(torch, gen, b, p, s, m, k, masked, device, layout)
        ivf_pq_scan.CHUNK = ch or chunk
        try:
            worst = max(worst, _check_k9(torch, ivf_pq_scan, ops, rr, f"K9 probed B={b} p={p} S={s} M={m} K={k} "
                                         f"rr={rr} mask={masked} layout={layout} chunk={ivf_pq_scan.CHUNK}"))
        finally:
            ivf_pq_scan.CHUNK = chunk
    for b, n, m, k, masked in K9_DENSE_CASES:
        codes = torch.randint(0, k, (n, m), generator=gen, dtype=torch.uint8).to(device)
        table = torch.randn((b, m, k), generator=gen).to(device)
        mask = (torch.rand(n, generator=gen) < 0.7).to(torch.uint8).to(device) if masked else None
        got = ivf_pq_scan.pq_scan(table, codes, mask)
        torch.cuda.synchronize()
        want = ivf_pq_scan.pq_scan_plain(table, codes, mask)
        what = f"K9 dense B={b} N={n} M={m} K={k} mask={masked}"
        if not torch.equal(torch.isinf(got), torch.isinf(want)):
            raise AssertionError(f"{what}: the masked rows differ")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        if err > IVF_RTOL * m * float(table.abs().max()):
            raise AssertionError(f"{what}: |err| {err}")
        worst_d = max(worst_d, err)
    # Repeats at the IVF-PQ cell's shape on normal tables (no equal scores):
    # every call must give the first call's result bit for bit, where a race
    # in the block's shared memory would show as a call that differs
    b, p, s, m, k, rr, masked = K9_CASES[-2]
    table, probe, codes, ids, mask = _k9_operands(torch, gen, b, p, s, m, k, masked, device)
    first = ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes, ids, mask, rr)
    for r in range(K9_REPEATS):
        again = ivf_pq_scan.ivf_pq_probe_scan(table, probe, codes, ids, mask, rr)
        if not (torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])):
            raise AssertionError(f"K9 probed at B={b} p={p} S={s} M={m} K={k} rr={rr}: call {r + 2} differs from call 1")
    log(f"[pq-kernels] K9 probed at B={b} p={p} S={s} M={m} K={k} rr={rr}: {K9_REPEATS + 1} calls gave the same "
        f"result bit for bit")
    log(f"[pq-kernels] K9 probed == plain at {len(K9_CASES)} shapes and {len(K9_LAYOUT_CASES)} layouts "
        f"({', '.join(sorted({str(c[7]) for c in K9_LAYOUT_CASES}))}), dense == plain at {len(K9_DENSE_CASES)} "
        f"shapes, scores within {IVF_RTOL:g} of M x max|table|, pools by the tie rule; max |err| probed "
        f"{worst:.3g}, dense {worst_d:.3g}")
    return {"k9_err": worst, "k9_dense_err": worst_d}


def _run_annbench(counted, argv, tag: str) -> tuple:
    """annbench.main(argv) with every launch count zeroed first, its JSON
    result and profile logged under ``tag``: (the result without the
    profile, the profile, the launches, K9's by entry, what it kept)."""
    from semadb_tpu_torch.ops.kernels import ivf_pq_scan
    from semadb_tpu_torch.tools import annbench

    _zero_counts(counted)
    keep: dict = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = annbench.main(list(argv), keep=keep)
    launches = {name: mod.LAUNCHES for name, mod in counted}
    by_entry = dict(ivf_pq_scan.LAUNCHES_BY)
    if rc != 0:
        raise AssertionError(f"annbench {argv} exited {rc}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    prof = res.pop("profile", None)
    log(f"[{tag}] {json.dumps(res)}")
    if prof is not None:
        log(f"[{tag}] profile of one batch: {json.dumps(prof)}")
    return res, prof, launches, by_entry, keep


def phase_ivfpq_cell(torch, counted, ivf_pq_scan, ivf_rerank, baseline=None) -> dict:
    """The IVF-PQ cell through annbench.main, then K9 and K4 on the operands
    one real search of the cell passes them. With ``baseline`` (another K9
    library, :func:`load_k9_baseline`) that library is checked on the same
    operands and timed beside the tree's K9, in turns: baseline, tree, tree,
    baseline."""
    res, prof, launches, by_entry, keep = _run_annbench(counted, PQ_CELL_ARGV, "ivfpq-cell")
    k5_routes = _k5_routes(counted)
    if res["recall@10"] < PQ_CELL_RECALL or not res["pq"]["active"]:
        raise AssertionError(f"the IVF-PQ cell's recall@10 {res['recall@10']} is below {PQ_CELL_RECALL}, "
                             f"or PQ is not active: {res['pq']}")
    if by_entry.get("probed", 0) <= 0 or launches["K4"] <= 0 or launches["K3"] != 0:
        raise AssertionError(f"the IVF-PQ cell must run K9 and K4, and not K3: {launches}, K9 {by_entry}")
    log(f"[ivfpq-cell] launches during the cell's searches: {launches}; K9 by entry {by_entry}; K5 by route "
        f"{k5_routes}")
    idx, test = keep["index"], keep["queries"]
    ops: dict = {}
    idx.search_batch_async(test[: res["batch"]], LIMIT, keep=ops)
    k9_ops, k4_ops = ops["k9"], ops["k4"]
    table, probe, codes, ids, _, rr = k9_ops
    B, p = probe.shape
    C, S, M = codes.shape
    K = table.shape[2]
    err9 = _check_k9(torch, ivf_pq_scan, k9_ops[:5], rr, "K9 on the IVF-PQ cell")
    q, pool_i = k4_ops[1], k4_ops[2]
    err4 = check_rows(torch, ivf_rerank.ivf_exact_rerank_plain(*k4_ops), ivf_rerank.ivf_exact_rerank(*k4_ops),
                      _k4_dist_of(torch, idx.vectors, q, idx.metric),
                      _k4_atol(torch, idx.vectors[: 1 + int(pool_i.max())], q), "K4 on the IVF-PQ cell")
    nb = _k9_bytes(torch, probe, ids, M, K, rr)
    one = (table[:1].contiguous(), probe[:1].contiguous()) + tuple(k9_ops[2:])
    sides = {"": ivf_pq_scan.ivf_pq_probe_scan}
    if baseline is not None:
        sides["base_"] = functools.partial(_k9_baseline_call, ivf_pq_scan, baseline)
        err_base = _check_k9(torch, ivf_pq_scan, k9_ops[:5], rr, "the K9 baseline on the IVF-PQ cell",
                             fn=sides["base_"])
    order = ("base_", "", "", "base_") if baseline is not None else ("",)
    times: dict = {}
    for tag in order:  # in turns, so that drift in the card's clock falls on both
        for what, ops in (("ms", k9_ops), ("b1_ms", one)):
            times.setdefault(tag + what, []).append(_device_ms(
                torch, functools.partial(sides[tag], *ops), runs=IVF_TIMED_RUNS, kernel=ivf_pq_scan.KERNELS["probed"]))
    times = {key: float(np.mean(v)) for key, v in times.items()}
    t9, t9_b1 = times["ms"], times["b1_ms"]
    t9_plain = _device_ms(torch, functools.partial(ivf_pq_scan.ivf_pq_probe_scan_plain, *k9_ops), runs=3)
    call_b1 = _median_call_ms(torch, functools.partial(ivf_pq_scan.ivf_pq_probe_scan, *one))
    b1_plain = _device_ms(torch, functools.partial(ivf_pq_scan.ivf_pq_probe_scan_plain, *one), runs=3)
    b1_bytes = _k9_bytes(torch, probe[:1], ids, M, K, rr)["bytes"]
    k9 = {"launches": by_entry["probed"], "max_abs_err": err9, "ms": t9, "plain_ms": t9_plain,
          "bound_ms": _bound_ms(nb["bytes"]), "bound_by": "bytes", **nb, "b1_ms": t9_b1, "b1_call_ms": call_b1,
          "b1_plain_ms": b1_plain,
          "b1_bound_ms": _bound_ms(b1_bytes), "shape": {"B": B, "p": p, "C": C, "S": S, "M": M, "K": K, "rr": rr},
          **{key: v for key, v in times.items() if key.startswith("base_")}}
    # The dense entry at the batch's tables over K9_DENSE_ROWS rows, filled
    # with the codes of the cell's first clusters and masked by their NIL
    # slots (the cell's own overflow pool is empty)
    n_cl = -(-K9_DENSE_ROWS // S)
    dmask = (ids[:n_cl] != -1).reshape(-1).to(torch.uint8)
    dense_ops = (table, codes[:n_cl].reshape(-1, M), dmask)
    want_d = ivf_pq_scan.pq_scan_plain(*dense_ops)
    got_d = ivf_pq_scan.pq_scan(*dense_ops)
    fin = torch.isfinite(want_d)
    if not torch.equal(fin, torch.isfinite(got_d)):
        raise AssertionError("K9 dense on the IVF-PQ cell's codes: the masked rows differ")
    err_d = float((got_d[fin] - want_d[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err_d > IVF_RTOL * M * float(table.abs().max()):
        raise AssertionError(f"K9 dense on the IVF-PQ cell's codes: |err| {err_d}")
    t9d = _device_ms(torch, functools.partial(ivf_pq_scan.pq_scan, *dense_ops), runs=IVF_TIMED_RUNS,
                     kernel=ivf_pq_scan.KERNELS["dense"])
    t9d_plain = _device_ms(torch, functools.partial(ivf_pq_scan.pq_scan_plain, *dense_ops), runs=3)
    dense = {"ms": t9d, "plain_ms": t9d_plain, "bound_ms": _bound_ms(_k9_dense_bytes(*dense_ops)),
             "max_abs_err": err_d,
             "shape": {"B": B, "N": int(dense_ops[1].shape[0]), "M": M, "K": K, "live": int(dmask.sum())}}
    nb4, rows4 = _k4_bytes(torch, idx.vectors, q, pool_i, k4_ops[3], LIMIT)
    t4 = _k4_times(torch, ivf_rerank, k4_ops)
    t4_plain = _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *k4_ops), runs=3)
    k4 = {"max_abs_err": err4, "launches": launches["K4"], "bound_ms": _bound_ms(nb4), "distinct_rows": rows4,
          "rr": rr, "plain_ms": t4_plain, **t4}
    log(f"[ivfpq-cell] K9 == plain and K4 == plain on the cell's operands (B={B}, p={p}, C={C}, S={S}, M={M}, "
        f"K={K}, rr={rr}); max |err| K9 {err9:.3g}, K4 {err4:.3g}")
    log(f"[ivfpq-cell] K9 probed {t9:.4f} ms a call (device, mean of {IVF_TIMED_RUNS}), bound {k9['bound_ms']:.4f} "
        f"ms by bytes ({nb['bytes']} B: {nb['distinct_clusters']} distinct probed clusters, {nb['live_slots_distinct']} "
        f"live slots), {k9['bound_ms'] / t9:.1%} of it; plain {t9_plain:.4f} ms; B=1 {t9_b1:.4f} ms on the device "
        f"(bound {k9['b1_bound_ms']:.5f}), {call_b1:.4f} ms a call, plain {b1_plain:.4f} ms")
    if baseline is not None:
        log(f"[ivfpq-cell] the K9 baseline == plain on the same operands (max |err| {err_base:.3g}): "
            f"{times['base_ms']:.4f} ms a call ({k9['bound_ms'] / times['base_ms']:.1%} of the bound), B=1 "
            f"{times['base_b1_ms']:.4f} ms; the tree's K9 {t9:.4f} and {t9_b1:.4f} ms (each the mean of two windows, "
            f"in turns base, tree, tree, base): {times['base_ms'] / t9:.2f}x and {times['base_b1_ms'] / t9_b1:.2f}x")
    log(f"[ivfpq-cell] K9 dense == plain on the cell's tables over the codes of its first clusters "
        f"{dense['shape']} (max |err| {err_d:.3g}): {t9d:.4f} ms (bound {dense['bound_ms']:.4f}, "
        f"{dense['bound_ms'] / t9d:.1%} of it); plain {t9d_plain:.4f} ms")
    log("[ivfpq-cell] " + _k4_line("K4 at rr = 256", t4, k4["bound_ms"]) + f"; plain {t4_plain:.4f} ms")
    return {"res": res, "profile": prof, "k9": k9, "k9_dense": dense, "k4": k4,
            "k5": {"launches": launches["K5"], "by_route": k5_routes}}


def phase_fused_cell(torch, counted, ivf_scan, ivf_rerank) -> dict:
    """The fused cell through annbench.main, then K3 and K4 on the operands
    one real search of the cell passes them."""
    res, prof, launches, _, keep = _run_annbench(counted, FUSED_CELL_ARGV, "fused-cell")
    shape = {key: res[key] for key in FUSED_CELL_SHAPE}
    if shape != FUSED_CELL_SHAPE:
        raise AssertionError(f"the fused cell took {shape}, not the predicted {FUSED_CELL_SHAPE}")
    if res["recall@10"] < FUSED_CELL_RECALL:
        raise AssertionError(f"the fused cell's recall@10 {res['recall@10']} is below {FUSED_CELL_RECALL}")
    if launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the fused cell did not run K3 and K4 on the card: {launches}")
    fused, views = keep["index"], keep["views"]
    inner = fused.index
    if ivf_rerank.route_of(inner.vectors) != "element":
        raise AssertionError(f"K4 takes the {ivf_rerank.route_of(inner.vectors)} route at D = {fused.aug_dim}")
    psi, _ = fused._psi([v[: res["batch"]] for v in views], None)
    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, inner, psi, "the fused cell")
    t4 = _k4_times(torch, ivf_rerank, kc["k4_ops"])
    k3 = {"ms": kc["t3"]["ms"], "plain_ms": kc["t3_plain"], "bound_ms": _bound_ms(kc["k3_bytes"]["distinct"]),
          "max_abs_err": kc["err3"], "launches": launches["K3"], "call_ms": kc["k3_call"],
          "shape": {key: kc[key] for key in ("B", "p", "S", "r", "rr")}, "slab_dtype": res["slab_dtype"],
          **{key: kc["t3"][key] for key in ("event_ms", "share", "measured_by")}}
    k4 = {"plain_ms": kc["t4_plain"], "bound_ms": _bound_ms(kc["k4_bytes"]), "max_abs_err": kc["err4"],
          "launches": launches["K4"], "route": "element", "D": fused.aug_dim, "dedup": kc["dedup"], **t4}
    log(f"[fused-cell] launches {launches}; K3 == plain and K4 == plain on the cell's operands "
        f"({k3['shape']}, {res['slab_dtype']}); max |err| K3 {kc['err3']:.3g}, K4 {kc['err4']:.3g}")
    log(f"[fused-cell] K3 {k3['ms']:.4f} ms a call (bound {k3['bound_ms']:.4f}, {k3['bound_ms'] / k3['ms']:.1%}); "
        f"from the {k3['measured_by']}, the same calls by CUDA events {k3['event_ms']:.4f} ms; a call with its "
        f"host work {k3['call_ms']:.4f} ms; plain {k3['plain_ms']:.4f} ms")
    log("[fused-cell] " + _k4_line("K4 on its element route at D = 194", t4, k4["bound_ms"])
        + f"; plain {k4['plain_ms']:.4f} ms")
    return {"res": res, "profile": prof, "k3": k3, "k4": k4}


def phase_pq_fused_http(torch, counted, device, seed: int, n_points: int = HTTP_PQ_POINTS) -> dict:
    """A collection with IVF-PQ, flat-PQ and fused properties over the port's
    node and HTTP v2 server, every result checked against numpy."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.ops.kernels import ivf_pq_scan
    from semadb_tpu_torch.ops.topk import tie_rule_errors
    from semadb_tpu_torch.shard import pointstore
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like_views

    name = "pqfused"
    pq = {"type": "product", "product": {"numCentroids": 256, "numSubVectors": 8, "triggerThreshold": 10000}}
    d1, d2 = HTTP_VIEWS
    schema = {
        "ivfpq": {"type": "vectorIVF", "vectorIVF": {"vectorSize": d1, "distanceMetric": "euclidean", "quantizer": pq}},
        "flatpq": {"type": "vectorFlat", "vectorFlat": {"vectorSize": d1, "distanceMetric": "euclidean",
                                                        "quantizer": pq}},
        "fused": {"type": "vectorFused", "vectorFused": {"assignCopies": 4, "views": [
            {"vectorSize": d1, "distanceMetric": "euclidean", "weight": 0.7},
            {"vectorSize": d2, "distanceMetric": "euclidean", "weight": 0.3}]}},
    }
    ds1, ds2 = embedding_like_views(n_points, [d1, d2], 10, seed=seed + 13)
    x1, x2 = ds1.train.astype(np.float64), ds2.train.astype(np.float64)
    rng = np.random.default_rng([seed, 13])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: i for i, pid in enumerate(ids)}
    checked = {"ivfpq": 0, "flatpq": 0, "fused": 0}
    hits = {"ivfpq": 0, "fused": 0}
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_pq_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            out = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema, "shardPlacement": "device"})
            assert out == {"message": "collection created"}, out
            col = srv.node.get_collection(bq.USER["X-User-Id"], name)
            col.user_plan = srv.plan
            t0 = time.perf_counter()
            for lo in range(0, n_points, 5000):
                pts = [Point.from_map({"ivfpq": ds1.train[i].tolist(), "flatpq": ds1.train[i].tolist(),
                                       "fused": [ds1.train[i].tolist(), ds2.train[i].tolist()]}, uuid.UUID(ids[i]))
                       for i in range(lo, min(lo + 5000, n_points))]
                failed = srv.node.insert_points(col, pts)
                assert failed == [], failed
            ingest_s = time.perf_counter() - t0

            def indices_and_nodes(shard):
                nodes = []
                shard.db.read(lambda bm: nodes.extend(
                    pointstore.get_point_node_id_by_uuid(bm.get(pointstore.POINTS_BUCKET_NAME), uuid.UUID(pid))
                    for pid in ids))
                return (shard.device_indices["index/vectorFlat/flatpq"],
                        shard.device_indices["index/vectorIVF/ivfpq"], np.asarray(nodes, np.int64))

            flat, ivf, nodes = srv.node.shard_manager.do_with_shard(col, col.shard_ids[0], indices_and_nodes)
            if not (flat.store.fitted and ivf.pq_active):
                raise AssertionError("the product quantizers did not fit at 10,000 points")
            # numpy's ADC over the flat store's own codes (row i's at its node
            # id) and codebooks (and rotation)
            st = flat.store.state
            codes = st.codes.cpu().numpy()[nodes].astype(np.int64)
            cb = st.aux.cpu().numpy().astype(np.float64)
            rot = None if st.rot is None else st.rot.cpu().numpy().astype(np.float64)
            for qi in range(len(ds1.test)):
                q1, q2 = ds1.test[qi], ds2.test[qi]
                d_ivf = ((x1 - q1.astype(np.float64)) ** 2).sum(-1)
                d_fused = 0.7 * d_ivf + 0.3 * ((x2 - q2.astype(np.float64)) ** 2).sum(-1)
                qr = q1.astype(np.float64) if rot is None else q1.astype(np.float64) @ rot
                tab = ((qr.reshape(8, 1, -1) - cb) ** 2).sum(-1)  # [M, K]
                d_adc = tab[np.arange(8)[None, :], codes].sum(-1)
                for prop, key, body, dist in (
                    ("ivfpq", "vectorIVF", {"vector": q1.tolist()}, d_ivf),
                    ("flatpq", "vectorFlat", {"vector": q1.tolist()}, d_adc),
                    ("fused", "vectorFused", {"vectors": [q1.tolist(), q2.tolist()]}, d_fused),
                ):
                    res = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": {
                        "property": prop, key: {**body, "operator": "near", "limit": 10}}, "limit": 10})
                    got = [row_of[pnt["_id"]] for pnt in res["points"]]
                    if len(got) != 10:
                        raise AssertionError(f"HTTP {prop}: {len(got)} results")
                    atol = 1e-4 * max(1.0, float(np.abs(dist).max()))
                    for pnt, row in zip(res["points"], got):
                        if abs(pnt["_distance"] - dist[row]) > 1e-4 * max(1.0, abs(dist[row])):
                            raise AssertionError(f"HTTP {prop}: distance {pnt['_distance']} of a point at {dist[row]}")
                    truth = np.argsort(dist, kind="stable")[:10]
                    if prop == "flatpq":
                        errs = tie_rule_errors(dist[truth], truth.tolist(), [p["_distance"] for p in res["points"]],
                                               got, lambda i: dist[i], atol=atol)
                        if errs:
                            raise AssertionError(f"HTTP flatpq against numpy's ADC: {errs[:3]}")
                    else:
                        hits[prop] += len(set(truth.tolist()) & set(got))
                    checked[prop] += 1
            launches = {nm: mod.LAUNCHES for nm, mod in counted}
            by_entry = dict(ivf_pq_scan.LAUNCHES_BY)
            # K9's dense entry at the flat index's shape: one query over its codes
            table = flat.store.prepare_queries(torch.from_numpy(ds1.test[:1]).to(device))
            dense_ops = (table, st.codes, flat.exists.view(torch.uint8))
            t9d = _device_ms(torch, functools.partial(ivf_pq_scan.pq_scan, *dense_ops), runs=IVF_TIMED_RUNS,
                             kernel=ivf_pq_scan.KERNELS["dense"])
            t9d_plain = _device_ms(torch, functools.partial(ivf_pq_scan.pq_scan_plain, *dense_ops), runs=3)
            call_ms = _median_call_ms(torch, functools.partial(ivf_pq_scan.pq_scan, *dense_ops))
            err = float((ivf_pq_scan.pq_scan(*dense_ops) - ivf_pq_scan.pq_scan_plain(*dense_ops))
                        .nan_to_num(posinf=0.0).abs().max())
            dense = {"ms": t9d, "plain_ms": t9d_plain, "call_ms": call_ms,
                     "bound_ms": _bound_ms(_k9_dense_bytes(*dense_ops)), "max_abs_err": err,
                     "shape": {"B": 1, "N": int(st.codes.shape[0]), "M": 8, "K": 256,
                               "live": int(flat.exists.sum())}}
    recall = {prop: h / (10 * checked[prop]) for prop, h in hits.items()}
    log(f"[pq-http] {n_points} points (vectorIVF + PQ, vectorFlat + PQ, vectorFused {d1}+{d2}) in one shard through "
        f"ClusterNode.insert_points in {ingest_s:.2f} s; HTTP searches checked {checked}: recall@10 {recall}, every "
        f"returned distance exact; flat PQ equal to numpy's ADC by the tie rule; launches {launches}, K9 by entry "
        f"{by_entry}")
    log(f"[pq-http] K9 dense at the flat index's shape {dense['shape']}: {t9d:.4f} ms on the device (bound "
        f"{dense['bound_ms']:.5f}), {call_ms:.4f} ms a call; plain {t9d_plain:.4f} ms")
    if min(recall.values()) < HTTP_PQ_RECALL:
        raise AssertionError(f"HTTP recall@10 {recall} is below {HTTP_PQ_RECALL}")
    if by_entry.get("probed", 0) <= 0 or by_entry.get("dense", 0) <= 0 or launches["K3"] <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the HTTP searches did not run K9's two entries, K3 and K4: {launches}, K9 {by_entry}")
    return {"recall": recall, "launches": launches, "k9_by_entry": by_entry, "dense": dense}


# -- the Vamana engine: K10, K11, the cell, v1 and v2 over HTTP -------------------

VAMANA_RTOL = 1e-5  # of the magnitude of the summed terms (real-valued data)
VAMANA_RECALL_GAP = 0.002  # kernel against plain version, real-valued data
VAMANA_REPEATS = 51
VAMANA_TIMED_RUNS = 10
VAMANA_CELL_RECALL = 0.98  # the JAX package read 0.9989 here (TPU history, BENCHMARKS.md:423-424)
HTTP_VAMANA_POINTS = 20_000
HTTP_VAMANA_RECALL = 0.95
# Deletes and as many updates a collection over HTTP in phases 16 and 21: a
# depth cut so that the whole script, phase 23 included, stays near 800 s
HTTP_VAMANA_WRITES = 500
LIBRARY_NONE_K10 = "none: no one PyTorch call walks a graph"
LIBRARY_NONE_K11 = "none: no one PyTorch call prunes a pool"
# K10 on integer-valued graphs, every output bit for bit: (B, L, W, R,
# metric, seeds, track_visited, graph); "nil": 90% of the rows keep a random
# number of edges, "one": a graph of one user point, "inf": the start node
# and every 7th row at distance inf (a real entry at inf heads the list, so
# the seeds' merge keeps every new entry), "d37": D = 37 (element loads). The last 10 are the boundaries of the geometry (csrc/vamana_search.cu
# pick_geometry): a batch no multiple of the 4 queries a block, B on either
# side of 1,024 (8 or 4 warps a query), W*R and S past 128 (a block a query),
# L = 1
K10_CASES = [
    (1, 25, 1, 32, "euclidean", False, True, "random"), (7, 40, 2, 64, "euclidean", True, False, "random"),
    (8192, 40, 2, 64, "euclidean", True, False, "random"), (512, 75, 8, 64, "euclidean", False, True, "random"),
    (4096, 75, 8, 64, "euclidean", True, True, "random"), (7, 100, 2, 64, "dot", True, False, "random"),
    (7, 100, 8, 64, "cosine", False, True, "random"), (7, 40, 2, 32, "haversine", True, True, "random"),
    (7, 512, 8, 64, "euclidean", True, True, "random"), (1, 512, 1, 32, "euclidean", False, False, "random"),
    (7, 75, 8, 64, "euclidean", False, True, "nil"), (7, 25, 8, 32, "euclidean", True, True, "one"),
    (8192, 40, 2, 64, "cosine", True, False, "random"), (512, 75, 8, 64, "dot", False, True, "random"),
    (7, 40, 2, 64, "haversine", False, False, "random"),
    (4097, 40, 2, 64, "euclidean", True, False, "random"), (1024, 75, 8, 64, "euclidean", True, True, "random"),
    (1025, 75, 8, 64, "euclidean", False, True, "random"), (5, 40, 1, 129, "euclidean", False, True, "random"),
    (9, 129, 2, 64, "euclidean", True, False, "random"), (17, 1, 1, 32, "euclidean", False, True, "random"),
    (33, 40, 2, 64, "euclidean", True, False, "inf"), (33, 75, 8, 64, "euclidean", True, True, "inf"),
    (33, 40, 2, 64, "euclidean", True, False, "d37"), (33, 75, 8, 64, "dot", False, True, "d37"),
]
K10_REPEAT_CASES = (2, 3, 4)  # indices into K10_CASES: the query, pass-1 and pass-2 shapes
# K11 on integer-valued pools, rows bit for bit at alpha 1.0 and 1.2: (B, P,
# R, metric, D); pools past the stage (csrc/vamana_prune.cu: P = 1,500 and
# 2,048, D = 1,536, some of the P = 224 pools) read the rows from device
# memory, D = 131 by element loads; P = 33 is one past a panel
K11_CASES = [
    (1, 160, 64, "euclidean", 128), (7, 224, 64, "euclidean", 128), (512, 160, 64, "euclidean", 128),
    (4096, 224, 64, "euclidean", 128), (7, 128, 32, "dot", 128), (7, 128, 64, "cosine", 128),
    (7, 160, 32, "haversine", 2), (7, 1500, 64, "euclidean", 128), (7, 224, 64, "euclidean", 1536),
    (9, 33, 32, "euclidean", 128), (7, 2048, 64, "dot", 128), (9, 1500, 64, "euclidean", 131),
]
K11_REPEAT_CASE = 3


def _k10_graph(vo, device, b, R, metric, kind, integer, seed):
    dim = 2 if metric == "haversine" else (37 if kind == "d37" else 128)
    n = 1 if kind == "one" else (100_000 if b >= 512 else 5_000)
    v, a = vo.random_graph(n, dim, R, integer=integer, metric=metric, seed=seed, device=device,
                           nil_rows=0.9 if kind == "nil" else 0.25)
    if kind == "inf":
        v[1, 0] = 3e38  # (3e38 - q)^2 overflows: the start node and these rows lie at distance inf
        v[2::7, 0] = 3e38
    return v, a


def _k10_equal(torch, got, want, what) -> None:
    for name, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K10 {what}: {name} differs from the plain version at "
                                 f"{(g != w).nonzero()[:3].tolist()}")


def _k10_top(torch, out, k=10):
    from semadb_tpu_torch.ops.topk import sort_by_distance

    i = out.cand_ids
    d = out.cand_dists.masked_fill(i == 1, float("inf"))
    d, i = sort_by_distance(d, i.masked_fill(i == 1, -1))
    return d[:, :k], i[:, :k]


def _k10_real_check(torch, vectors, queries, got, want, metric, truth, what) -> float:
    """Real-valued data: the top-10 of the kernel's walk against the plain
    version's by the tie rule, distances within VAMANA_RTOL of the terms'
    magnitude, and recall@10 against ``truth`` (ids [B, 10]) within
    VAMANA_RECALL_GAP. Returns the largest |error| of the distances."""
    from semadb_tpu_torch.ops.distance import gather_distance

    gd, gi = _k10_top(torch, got)
    wd, wi = _k10_top(torch, want)
    mag = float(vectors.abs().max()) ** 2 * vectors.shape[1] * 4
    cap = vectors.shape[0]

    def dist_of(b, i):
        ids = torch.tensor([[max(int(i), 0)]], device=vectors.device)
        return float(gather_distance(vectors, ids.clamp(0, cap - 1), queries[b : b + 1], metric)[0, 0])

    err = check_rows(torch, (wd, wi), (gd, gi), dist_of, VAMANA_RTOL * mag, what)
    t = torch.as_tensor(np.asarray(truth), device=gi.device)

    def recall(ids):
        return float((ids[:, :, None] == t[:, None, :]).any(-1).float().mean())

    rg, rw = recall(gi), recall(wi)
    if abs(rg - rw) > VAMANA_RECALL_GAP:
        raise AssertionError(f"K10 {what}: recall@10 {rg:.4f} against the plain version's {rw:.4f}")
    return err


def phase_vamana_kernels(torch, vamana_search, vamana_prune, device) -> dict:
    """K10 and K11 against their plain versions on the card."""
    from semadb_tpu_torch.ops.distance import pairwise_distance
    from semadb_tpu_torch.tools import vamana_operands as vo

    calls = 0
    for c, (b, L, W, R, metric, seeded, track, kind) in enumerate(K10_CASES):
        v, a = _k10_graph(vo, device, b, R, metric, kind, True, seed=c)
        q = vo.random_queries(b, v.shape[1], integer=True, metric=metric, seed=100 + c, device=device)
        seeds = vo.random_seeds(b, L, v.shape[0], seed=200 + c, device=device) if seeded else None
        args = (v, a, q, L, W, 0, metric, seeds, track)
        got = vamana_search.vamana_beam_search(*args)
        torch.cuda.synchronize()
        want = vamana_search.beam_search_plain(*args)
        _k10_equal(torch, got, want, f"B={b} L={L} W={W} R={R} {metric} seeds={seeded} track={track} {kind}")
        calls += 1
        if c in K10_REPEAT_CASES:
            for _ in range(VAMANA_REPEATS):
                _k10_equal(torch, vamana_search.vamana_beam_search(*args), got, f"repeat at B={b} L={L} W={W}")
            calls += VAMANA_REPEATS
    real_err = 0.0
    for metric in ("euclidean", "cosine"):
        v, a = vo.random_graph(100_000, 128, 64, integer=False, metric=metric, seed=7, device=device)
        q = vo.random_queries(2048, 128, integer=False, metric=metric, seed=8, device=device)
        args = (v, a, q, 40, 2, 0, metric, None, False)
        got = vamana_search.vamana_beam_search(*args)
        want = vamana_search.beam_search_plain(*args)
        d = pairwise_distance(q, v, metric)
        d[:, :2] = float("inf")
        truth = torch.topk(d, 10, dim=1, largest=False).indices.cpu().numpy()
        real_err = max(real_err, _k10_real_check(torch, v, q, got, want, metric, truth, f"real {metric} B=2048"))
    log(f"[vamana-kernels] K10 == plain bit for bit at {len(K10_CASES)} integer-valued cases (L 1-512, W 1-8, "
        f"R 32-129, B 1-8192, seeds, rings, NIL rows, one node, rows at inf, D 37, 4 metrics) and "
        f"{VAMANA_REPEATS} repeats at "
        f"{len(K10_REPEAT_CASES)} shapes ({calls} calls); real-valued top-10 by the tie rule, max |err| "
        f"{real_err:.3g}")
    k11_calls = 0
    k11_unequal = 0.0  # the largest share of rows unequal to the plain version's
    for c, (b, p, R, metric, dim) in enumerate(K11_CASES):
        v, _ = vo.random_graph(20_000, dim, 8, integer=True, metric=metric, seed=300 + c, device=device)
        d, i, s = vo.prune_pools(v, b, p, metric, seed=400 + c)
        for alpha in (1.0, 1.2):
            args = (d, i, s, v, R, max(R, 8), alpha, metric)
            got = vamana_prune.vamana_robust_prune(*args)
            torch.cuda.synchronize()
            want = vamana_prune.robust_prune_plain(*args)
            k11_unequal = max(k11_unequal, float((got != want).any(1).float().mean()))
            if not torch.equal(got, want):
                bad = (got != want).any(1).nonzero()[:3, 0].tolist()
                raise AssertionError(f"K11 B={b} P={p} R={R} {metric} D={dim} alpha={alpha}: rows {bad} differ")
            k11_calls += 1
            if c == K11_REPEAT_CASE and alpha == 1.2:
                for _ in range(VAMANA_REPEATS):
                    if not torch.equal(vamana_prune.vamana_robust_prune(*args), got):
                        raise AssertionError(f"K11 repeat at B={b} P={p}: a row differs")
                k11_calls += VAMANA_REPEATS
    v, _ = vo.random_graph(20_000, 128, 8, integer=False, metric="euclidean", seed=9, device=device)
    d, i, s = vo.prune_pools(v, 4096, 224, "euclidean", seed=10)
    got = vamana_prune.vamana_robust_prune(d, i, s, v, 64, 64, 1.2, "euclidean")
    want = vamana_prune.robust_prune_plain(d, i, s, v, 64, 64, 1.2, "euclidean")
    same = float((got == want).all(1).float().mean())
    k11_unequal = max(k11_unequal, 1.0 - same)
    if same < 0.99:
        raise AssertionError(f"K11 on real-valued pools: only {same:.4f} of the rows equal the plain version's")
    log(f"[vamana-kernels] K11 == plain bit for bit at {len(K11_CASES)} integer-valued cases x alpha 1.0, 1.2 "
        f"(B 1-4096, P 33-2048, R 32/64, 4 metrics, D 2-1536) and {VAMANA_REPEATS} repeats ({k11_calls} calls); "
        f"real-valued pools at B=4096 P=224: {same:.4f} of the rows equal (a near-tie decision may part)")
    return {"k10_err": real_err, "k10_calls": calls, "k11_calls": k11_calls, "k11_real_same": same,
            "k11_unequal": k11_unequal}


def load_vamana_baseline(directory: str) -> tuple:
    """Build and load another K10 and K11 with the same C interfaces
    (``vamana_search.cu`` and ``vamana_prune.cu`` in ``directory``, their
    ``vamana_common.cuh`` beside them; e.g. the parent commit's), both at
    once, to time beside the tree's; they launch through
    ``vamana_search.launch`` and ``vamana_prune.launch`` and count nothing.
    Returns (the K10 library, the K11 library)."""
    import os

    from semadb_tpu_torch.ops.kernels import vamana_prune, vamana_search
    from semadb_tpu_torch.utils.build import NVCC_FLAGS, build_library, nvcc

    header = os.path.join(directory, "vamana_common.cuh")

    def one(stem, mod):
        source = os.path.join(directory, stem + ".cu")
        path, _ = build_library(stem + "_baseline", source, nvcc(), NVCC_FLAGS, (header,))
        log(f"[build] {stem} baseline {source}: built into {path}")
        return mod.bind(path)

    with ThreadPoolExecutor(2) as pool:
        k10 = pool.submit(one, "vamana_search", vamana_search)
        k11 = pool.submit(one, "vamana_prune", vamana_prune)
        return k10.result(), k11.result()


def _vamana_turns(torch, tree, base, kernel) -> dict:
    """Device ms a call of ``tree`` and, where ``base`` is given, of the
    baseline on the same operands, in turns base, tree, tree, base, so that
    drift in the card's clock falls on both; each the mean of its windows."""
    sides = {"": tree, "base_": base}
    times: dict = {}
    for tag in ("base_", "", "", "base_") if base is not None else ("",):
        times.setdefault(tag + "ms", []).append(_device_ms(torch, sides[tag], runs=VAMANA_TIMED_RUNS, kernel=kernel))
    return {key: float(np.mean(v)) for key, v in times.items()}


def _vamana_launch_split(res, launches) -> dict:
    """K10's and K11's launches in the cell by shape, from the build's own
    counts: a walk and a prune each insert batch, a prune each overflow
    round; K10's other launches are query walks, and K11 has none."""
    split = res["build_split_s"]
    p1, p2 = split["pass1_batches"], split["pass2_batches"]
    overflow = split["pass1_overflow_rounds"] + split["pass2_overflow_rounds"]
    out = {"K10": {"pass1": p1, "pass2": p2, "query": launches["K10"] - p1 - p2},
           "K11": {"pass1": p1, "pass2": p2, "overflow": overflow}}
    if out["K10"]["query"] <= 0 or launches["K11"] != p1 + p2 + overflow:
        raise AssertionError(f"the cell's launches {launches} do not split into its build's {split}")
    return out


def phase_vamana_cell(torch, counted, vamana_search, vamana_prune, baseline=None) -> dict:
    """The Vamana engine cell (bench.py's BENCH_MODE=plain) through
    annbench.main, then K10 and K11 on the cell's own graph. With
    ``baseline`` (:func:`load_vamana_baseline`) those libraries are checked
    on the same operands and timed beside the tree's kernels."""
    from semadb_tpu_torch.tools import vamana_operands as vo

    res, prof, launches, _, keep = _run_annbench(counted, ("--engine", "vamana"), "vamana-cell")
    if res["recall@10"] < VAMANA_CELL_RECALL:
        raise AssertionError(f"Vamana cell recall@10 {res['recall@10']} is below {VAMANA_CELL_RECALL}")
    if launches["K10"] <= 0 or launches["K11"] <= 0:
        raise AssertionError(f"the Vamana cell did not run K10 and K11: {launches}")
    by_shape = _vamana_launch_split(res, launches)
    idx, gt = keep["index"], keep["ground_truth"]
    dim, R = idx.config.dim, idx.config.degree_bound
    k10_base, k11_base = baseline if baseline is not None else (None, None)
    out = {"res": res, "profile": prof, "launches": launches, "launches_by_shape": by_shape}

    def base_of(mod, lib, args):
        return None if lib is None else functools.partial(mod.launch, lib, *args)

    def rows_equal(got, want, what):
        same = float((got == want).all(1).float().mean())
        if same < 0.99:
            raise AssertionError(f"{what}: only {same:.4f} of the rows equal the plain version's")
        return same

    # K10 at the query walk (the cell's first batch, its entry seeds), at
    # pass 1's walk and at pass 2's; the baseline at each
    walks = vo.cell_walks(idx, keep["queries"], res["batch"], res["search_size"])
    args, shape = walks["query"]
    b, q = res["batch"], args[2]
    want = vamana_search.beam_search_plain(*args)
    err = _k10_real_check(torch, idx.state.vectors, q, vamana_search.vamana_beam_search(*args), want,
                          idx.config.metric, gt[:b] + 2, f"the cell's batch B={b}")
    if k10_base is not None:
        _k10_real_check(torch, idx.state.vectors, q, vamana_search.launch(k10_base, *args), want, idx.config.metric,
                        gt[:b] + 2, f"the K10 baseline on the cell's batch B={b}")
    k10 = {"max_abs_err": err, **vo.k10_least_bytes(*args), "hops_per_query": float(want.hops.float().mean()),
           "shape": shape,
           **_vamana_turns(torch, functools.partial(vamana_search.vamana_beam_search, *args),
                           base_of(vamana_search, k10_base, args), vamana_search.KERNELS),
           "plain_ms": _median_call_ms(torch, functools.partial(vamana_search.beam_search_plain, *args), runs=3)}
    k10["bound_ms"] = _bound_ms(k10["bytes"])
    for key, name in (("build_shape", "pass1"), ("pass2_shape", "pass2")):
        wargs, wshape = walks[name]
        k10[key] = {"shape": wshape,
                    **_vamana_turns(torch, functools.partial(vamana_search.vamana_beam_search, *wargs),
                                    base_of(vamana_search, k10_base, wargs),
                                    vamana_search.KERNELS),
                    **vo.k10_least_bytes(*wargs)}
        k10[key]["bound_ms"] = _bound_ms(k10[key]["bytes"])
    # K11 at pass 2's prune, pass 1's and an overflow round's; the baseline at each
    pools = vo.cell_pools(idx)
    k11 = {}
    for key, name in (("", "pass2"), ("build_shape", "pass1"), ("overflow_shape", "overflow")):
        pargs, pshape = pools[name]
        kwant = vamana_prune.robust_prune_plain(*pargs)
        same = rows_equal(vamana_prune.vamana_robust_prune(*pargs), kwant, f"K11 on the cell's {name} pools")
        if k11_base is not None:
            rows_equal(vamana_prune.launch(k11_base, *pargs), kwant, f"the K11 baseline on the cell's {name} pools")
        one = {"shape": pshape, "rows_equal": same, **vo.k11_least_bytes(*pargs[:3], dim, R),
               **_vamana_turns(torch, functools.partial(vamana_prune.vamana_robust_prune, *pargs),
                               base_of(vamana_prune, k11_base, pargs),
                               vamana_prune.KERNELS)}
        one["bound_ms"] = _bound_ms(one["bytes"])
        if key:
            k11[key] = one
        else:
            one["plain_ms"] = _median_call_ms(torch, functools.partial(vamana_prune.robust_prune_plain, *pargs),
                                              runs=3)
            k11.update(one)
    del pools
    out.update(k10=k10, k11=k11)

    def line(t):
        base = f", baseline {t['base_ms']:.4f} ms ({t['base_ms'] / t['ms']:.2f}x)" if "base_ms" in t else ""
        return f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, {t['bound_ms'] / t['ms']:.1%}{base})"

    log(f"[vamana-cell] K10 at the cell's query walk {line(k10)}; plain {k10['plain_ms']:.2f} ms; bound for "
        f"{k10['bytes'] / 1e9:.3f} GB: {k10['distinct_rows_scored']} distinct rows of {k10['rows_scored']} scored, "
        f"{k10['distinct_nodes_expanded']} of {k10['nodes_expanded']} expanded; {k10['hops_per_query']:.2f} hops a query; at pass 1's walk "
        f"{line(k10['build_shape'])}; at pass 2's {line(k10['pass2_shape'])}")
    log(f"[vamana-cell] K11 at pass 2's prune {line(k11)}; plain {k11['plain_ms']:.2f} ms; bound for "
        f"{k11['distinct_rows']} distinct rows of {k11['live_rows']} live, {k11['rows_equal']:.4f} of the rows "
        f"equal; at pass 1's {line(k11['build_shape'])}; at an overflow round's ({k11['overflow_shape']['shape']}) "
        f"{line(k11['overflow_shape'])}, {k11['overflow_shape']['rows_equal']:.4f} of the rows equal")
    log(f"[vamana-cell] launches by shape {by_shape}; cell launches {launches}")
    del keep
    return out


def phase_vamana_http(torch, counted, device, seed: int, n_points: int = HTTP_VAMANA_POINTS) -> dict:
    """A v1 collection and a v2 vectorVamana collection over the port's node
    and HTTP server: searches against numpy, deletes and updates, then a
    flush (the dirty-row snapshot), close and reopen."""
    import uuid
    from urllib.error import HTTPError

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like

    dim = HTTP_IVF_DIM
    ds = embedding_like(n_points + HTTP_VAMANA_WRITES, dim, 10, spread=0.5, seed=seed + 12)
    data, queries = ds.train[:n_points].copy(), ds.test
    moved_to = ds.train[n_points:]
    rng = np.random.default_rng([seed, 12])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: i for i, pid in enumerate(ids)}
    tags = [f"t{i % 4}" for i in range(n_points)]
    order = rng.permutation(n_points)
    deleted = order[:HTTP_VAMANA_WRITES]
    moved = order[HTTP_VAMANA_WRITES : 2 * HTTP_VAMANA_WRITES]
    v2_schema = {"vec": {"type": "vectorVamana", "vectorVamana": {"vectorSize": dim, "distanceMetric": "euclidean"}},
                 "tag": {"type": "string", "string": {"caseSensitive": True}}}
    live = np.ones(n_points, bool)

    def check(rows, what, flt=None) -> float:
        hits = 0
        for qv, row in zip(queries, rows):
            d = ((data.astype(np.float64) - qv.astype(np.float64)) ** 2).sum(-1)
            ok = live.copy() if flt is None else live & flt
            d[~ok] = np.inf
            truth = set(np.argsort(d, kind="stable")[:LIMIT].tolist())
            got = [row_of[pid] for pid, _ in row]
            if any(not ok[r] for r in got):
                raise AssertionError(f"{what}: a deleted or filtered-out point came back")
            hits += len(truth & set(got))
            for (_, dist), r in zip(row, got):
                if abs(dist - d[r]) > VAMANA_RTOL * max(1.0, d[r]):
                    raise AssertionError(f"{what}: distance {dist} of a point at {d[r]}")
        recall = hits / (LIMIT * len(rows))
        if recall < HTTP_VAMANA_RECALL:
            raise AssertionError(f"{what}: recall@10 {recall} is below {HTTP_VAMANA_RECALL}")
        return recall

    def v2_body(qv, flt=None):
        body = {"query": {"property": "vec", "vectorVamana": {"vector": qv.tolist(), "operator": "near",
                                                              "limit": LIMIT}}}
        if flt is not None:
            body["query"]["vectorVamana"]["filter"] = flt
        return body

    def searches(srv) -> dict:
        v1 = srv.base.replace("/v2/collections", "/v1/collections")
        out = {"v1": [[(p["id"], p["distance"]) for p in bq.http_json(v1, "POST", "/vone/points/search", {
            "vector": qv.tolist(), "limit": LIMIT})["points"]] for qv in queries]}
        out["v2"] = [[(p["_id"], p["_distance"]) for p in bq.http_json(
            srv.base, "POST", "/vtwo/points/search", v2_body(qv))["points"]] for qv in queries]
        rows = bq.http_json(srv.base, "POST", "/vtwo/points/search/batch",
                            {"queries": [v2_body(qv) for qv in queries]})["results"]
        out["v2_batch"] = [[(p["_id"], p["_distance"]) for p in row["points"]] for row in rows]
        flt = {"property": "tag", "string": {"value": "t1", "operator": "equals"}}
        out["v2_filtered"] = [[(p["_id"], p["_distance"]) for p in bq.http_json(
            srv.base, "POST", "/vtwo/points/search", v2_body(qv, flt))["points"]] for qv in queries]
        return out

    def check_all(res, what) -> dict:
        t1 = np.array([t == "t1" for t in tags])
        return {key: check(res[key], f"{what} {key}", t1 if key == "v2_filtered" else None) for key in res}

    with tempfile.TemporaryDirectory(prefix="semadb_smoke_vamana_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            v1 = srv.base.replace("/v2/collections", "/v1/collections")
            bq.http_json(v1, "POST", "", {"id": "vone", "vectorSize": dim, "distanceMetric": "euclidean"})
            bq.http_json(srv.base, "POST", "", {"id": "vtwo", "indexSchema": v2_schema})
            cols = {name: srv.node.get_collection(bq.USER["X-User-Id"], name) for name in ("vone", "vtwo")}
            for col in cols.values():
                col.user_plan = srv.plan
            t0 = time.perf_counter()
            bq.http_json(v1, "POST", "/vone/points", {"points": [
                {"id": ids[i], "vector": data[i].tolist(), "metadata": {"n": int(i)}} for i in range(1000)]})
            bq.http_json(srv.base, "POST", "/vtwo/points", {"points": [
                {"_id": ids[i], "vec": data[i].tolist(), "tag": tags[i]} for i in range(1000)]})
            for lo in range(1000, n_points, 5000):
                rows = range(lo, min(lo + 5000, n_points))
                for name, pts in (
                    ("vone", [Point.from_map({"vector": data[i].tolist(), "metadata": {"n": int(i)}},
                                             uuid.UUID(ids[i])) for i in rows]),
                    ("vtwo", [Point.from_map({"vec": data[i].tolist(), "tag": tags[i]}, uuid.UUID(ids[i]))
                              for i in rows]),
                ):
                    failed = srv.node.insert_points(cols[name], pts)
                    assert failed == [], failed
            ingest_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            before = searches(srv)
            search_s = time.perf_counter() - t0
            recall = check_all(before, "before the writes")
            t0 = time.perf_counter()
            for lo in range(0, len(deleted), 100):
                chunk = [ids[i] for i in deleted[lo : lo + 100]]
                bq.http_json(v1, "DELETE", "/vone/points", {"ids": chunk})
                bq.http_json(srv.base, "DELETE", "/vtwo/points", {"ids": chunk})
            live[deleted] = False
            for lo in range(0, len(moved), 100):
                rows = list(enumerate(moved[lo : lo + 100], start=lo))
                bq.http_json(v1, "PUT", "/vone/points", {"points": [
                    {"id": ids[i], "vector": moved_to[j].tolist(), "metadata": {"n": int(i)}} for j, i in rows]})
                bq.http_json(srv.base, "PUT", "/vtwo/points", {"points": [
                    {"_id": ids[i], "vec": moved_to[j].tolist()} for j, i in rows]})
            data[moved] = moved_to
            writes_s = time.perf_counter() - t0
            after = searches(srv)
            recall_after = check_all(after, "after the writes")
            for j, i in enumerate(moved[:20]):
                top = bq.http_json(v1, "POST", "/vone/points/search", {"vector": moved_to[j].tolist(), "limit": 1})
                if top["points"][0]["id"] != ids[i]:
                    raise AssertionError(f"an updated point does not find itself: {top['points'][0]}")
            chunks = {}
            for name in cols:
                col = srv.node.get_collection(bq.USER["X-User-Id"], name)
                col.user_plan = srv.plan
                chunks[name] = sum(srv.node.shard_manager.do_with_shard(col, sid, lambda s: s.flush())
                                   for sid in col.shard_ids)
        launches = {nm: mod.LAUNCHES for nm, mod in counted}
        with bq.serving(cfg, device) as srv:
            reopened = searches(srv)
        if reopened != after:
            bad = [key for key in after if reopened[key] != after[key]]
            raise AssertionError(f"after close and reopen the searches {bad} answer otherwise")
    log(f"[vamana-http] {n_points} points of {dim}-d into a v1 and a v2 vectorVamana collection (1,000 each over "
        f"HTTP) in {ingest_s:.2f} s; 10 single searches of each, a batch of 10 and 10 filtered (v2): recall@10 "
        f"{recall} against numpy, every distance exact, in {search_s:.2f} s; {HTTP_VAMANA_WRITES} deletes and "
        f"{HTTP_VAMANA_WRITES} updates a collection in {writes_s:.2f} s: recall@10 {recall_after}, no deleted id "
        f"back, 20 updated points find themselves; the flush "
        f"after the writes wrote {chunks} chunks (dirty rows only); after close and reopen every search answers "
        f"the same; launches {launches}")
    if launches["K10"] <= 0 or launches["K11"] <= 0:
        raise AssertionError(f"the HTTP Vamana phase did not run K10 and K11: {launches}")
    return {"recall": recall, "recall_after": recall_after, "launches": launches, "chunks": chunks}


# K10's quantized routes on integer operands, every output bit for bit: (B, L,
# W, R, width, route, bit metric or K, seeds, track_visited). width is D for
# the bit route (ceil(D / 32) words: 100 is 4 words, 200 is 7 off the 16-byte
# loads, 40 is 2) and M for the ADC route (96 at K = 256, a 96 KB table read
# through L2; 12 off the 8-byte loads; 4, 8, 16 staged). The first two are
# the BQ and PQ cells' query walk (B = 8,192, L = 75, W = 2, 16 seeds, the
# ring); the rest the geometry's boundaries (pick_geometry), with and without
# the ring (without it, the hole cut) and jaccard's empty unions
K10_CODE_CASES = [
    (8192, 75, 2, 64, 128, "bit", "hamming", True, True), (8192, 75, 2, 64, 8, "adc", 256, True, True),
    (7, 40, 2, 64, 128, "bit", "jaccard", True, False), (33, 75, 8, 64, 100, "bit", "hamming", False, True),
    (33, 75, 2, 64, 200, "bit", "jaccard", True, True), (9, 129, 2, 64, 40, "bit", "hamming", True, False),
    (1025, 75, 8, 64, 128, "bit", "hamming", False, True), (5, 40, 1, 129, 128, "bit", "jaccard", False, True),
    (17, 1, 1, 32, 128, "bit", "hamming", False, True), (4097, 40, 2, 64, 128, "bit", "hamming", True, False),
    (33, 75, 2, 64, 128, "bit", "hamming", False, False), (512, 75, 8, 64, 128, "bit", "jaccard", False, True),
    (1024, 75, 8, 64, 128, "bit", "hamming", True, True), (8192, 75, 2, 64, 128, "bit", "jaccard", True, True),
    (33, 75, 2, 64, 4, "adc", 256, True, False), (33, 75, 8, 64, 16, "adc", 256, False, True),
    (7, 40, 2, 64, 96, "adc", 256, True, True), (9, 129, 2, 64, 12, "adc", 16, True, False),
    (1025, 75, 8, 64, 8, "adc", 256, False, True), (4097, 40, 2, 64, 8, "adc", 256, True, False),
    (17, 1, 1, 32, 8, "adc", 256, False, True), (5, 40, 1, 129, 8, "adc", 256, False, False),
    (512, 75, 8, 64, 32, "adc", 256, False, True), (1024, 75, 8, 64, 96, "adc", 256, True, True),
    (33, 75, 2, 64, 8, "adc", 256, False, False), (8192, 75, 2, 64, 16, "adc", 256, True, True),
]
K10_CODE_REPEAT_CASES = (0, 1)  # the cells' query walks
VAMANA_BQ_ARGV = ("--engine", "vamana", "--quantizer", "binary")
VAMANA_BQ_RECALL = 0.92  # the JAX package read 0.9366 here (TPU history, BENCHMARKS.md:205-213)
VAMANA_PQ_ARGV = ("--engine", "vamana", "--quantizer", "product")
VAMANA_PQ_RECALL = 0.94  # the JAX package read 0.9615 here (TPU history, BENCHMARKS.md:489)
VAMANA_POOL_ARGV = ("--engine", "vamana", "--build", "pool", "--search-size", "75")
VAMANA_POOL_RECALL = 0.97  # at L = 75; the JAX package read 0.9929-0.9989 at 1M (TPU history, BENCHMARKS.md:454-460)
VAMANA_POOL_L40_RECALL = 0.95  # at L = 40, a second operating point of the same build
HTTP_QUANT_POINTS = 20_000
HTTP_QUANT_RECALL = 0.9
HTTP_QUANT_QUERIES = 50  # a kind of search; at 10 a recall moves in steps of 0.01 around its bar
ADC_RTOL = 1e-6  # of the summed terms' magnitude, real-valued tables
LIBRARY_NONE_K10_CODES = "none: no one PyTorch call walks a graph"


def _k10_code_operands(torch, vo, vamana_search, device, c, b, L, R, width, route, param, seeded, integer=True):
    dim = width if route == "bit" else 16
    n = 100_000 if b >= 512 else 5_000
    v, a = vo.random_graph(n, dim, R, integer=True, metric="euclidean", seed=500 + c, device=device)
    q = vo.random_queries(b, dim, integer=True, metric="euclidean", seed=600 + c, device=device)
    if route == "bit":
        codes, prep = vo.bit_codes(v, q, zero_rows=0.05 if param == "jaccard" else 0.0, seed=c)
        cq = vamana_search.Codes("binary", codes, prep, param)
    else:
        codes, prep = vo.adc_codes(v.shape[0], b, width, param, integer=integer, seed=700 + c, device=device)
        cq = vamana_search.Codes("product", codes, prep)
    seeds = vo.random_seeds(b, 16 if b >= 512 else L, v.shape[0], seed=800 + c, device=device) if seeded else None
    return v, a, q, seeds, cq


def phase_vamana_code_kernels(torch, vamana_search, device) -> dict:
    """K10's bit and ADC routes against their plain versions on the card:
    integer operands bit for bit (51 repeats at the cells' walks), then
    real-valued ADC tables within ADC_RTOL."""
    from semadb_tpu_torch.tools import vamana_operands as vo
    from semadb_tpu_torch.vectorstore.store import pq_gather_distance

    calls = 0
    for c, (b, L, W, R, width, route, param, seeded, track) in enumerate(K10_CODE_CASES):
        v, a, q, seeds, cq = _k10_code_operands(torch, vo, vamana_search, device, c, b, L, R, width, route, param,
                                                seeded)
        args = (v, a, q, L, W, 0, "euclidean", seeds, track, cq)
        got = vamana_search.vamana_beam_search(*args)
        torch.cuda.synchronize()
        want = vamana_search.beam_search_plain(*args)
        what = f"{route} B={b} L={L} W={W} R={R} width={width} {param} seeds={seeded} track={track}"
        _k10_equal(torch, got, want, what)
        calls += 1
        if c in K10_CODE_REPEAT_CASES:
            for _ in range(VAMANA_REPEATS):
                _k10_equal(torch, vamana_search.vamana_beam_search(*args), got, f"repeat at {what}")
            calls += VAMANA_REPEATS
    err = 0.0
    for c, m in enumerate((8, 96)):
        v, a, q, seeds, cq = _k10_code_operands(torch, vo, vamana_search, device, 90 + c, 2048, 75, 64, m, "adc",
                                                256, True, integer=False)
        args = (v, a, q, 75, 2, 0, "euclidean", seeds, True, cq)
        got = vamana_search.vamana_beam_search(*args)
        want = vamana_search.beam_search_plain(*args)
        ok = got.cand_ids >= 0
        ref = pq_gather_distance(cq.codes, got.cand_ids.clamp(min=0), cq.prepared, 256)
        mag = float(cq.prepared.abs().max()) * m
        e = float((got.cand_dists - ref).abs()[ok].max())
        same = float((got.cand_ids == want.cand_ids).float().mean())
        if e > ADC_RTOL * mag or same < 0.95:
            raise AssertionError(f"K10's ADC route on real tables (M={m}): |err| {e:.3g} against "
                                 f"{ADC_RTOL * mag:.3g}, {same:.4f} of the list equal to the plain version's")
        err = max(err, e)
    log(f"[vamana-codes] K10's bit and ADC routes == plain bit for bit at {len(K10_CODE_CASES)} integer-valued "
        f"cases (hamming and jaccard, D 40-200, M 4-96 staged and through L2, B 5-8192, L 1-129, W 1-8, seeds, "
        f"rings) and {VAMANA_REPEATS} repeats at the cells' walks ({calls} calls); real-valued ADC tables at M = 8 "
        f"and 96: max |err| {err:.3g} of the summed terms")
    return {"calls": calls, "adc_real_err": err}


def _code_walk(torch, idx, queries, batch: int):
    """The operands of the walk a quantized cell's search runs on its first
    batch: the queries, K10's codes and prepared queries, the entry seeds."""
    from semadb_tpu_torch.ops.kernels import vamana_search

    q = torch.from_numpy(np.ascontiguousarray(queries[:batch], np.float32)).to(idx.device)
    qa = idx._quant_args(q)
    cq = vamana_search.Codes(qa["quant"].kind, qa["qcodes"], qa["qquery"].contiguous(), qa["quant"].bit_metric)
    return q, cq, idx._seeds_for(q)


def phase_vamana_quant_cell(torch, counted, vamana_search, ivf_rerank, kind: str) -> dict:
    """A quantized Vamana cell (bench.py's BENCH_MODE=bq or pq) through
    annbench.main: recall against exact f32, QPS, the build's and the fit's
    seconds; then K10's route and K4 at the cell's own walk and rerank."""
    from semadb_tpu_torch.tools import vamana_operands as vo

    argv, floor = (VAMANA_BQ_ARGV, VAMANA_BQ_RECALL) if kind == "bq" else (VAMANA_PQ_ARGV, VAMANA_PQ_RECALL)
    route = "bit" if kind == "bq" else "adc"
    vamana_search.LAUNCHES_BY.clear()
    res, prof, launches, _, keep = _run_annbench(counted, argv, f"{kind}-cell")
    by_route = dict(vamana_search.LAUNCHES_BY)
    if res["recall@10"] < floor:
        raise AssertionError(f"the {kind} cell's recall@10 {res['recall@10']} is below {floor}")
    if by_route.get(route, 0) <= 0 or launches["K4"] <= 0 or launches["K11"] <= 0:
        raise AssertionError(f"the {kind} cell did not run K10's {route} route, K4 and K11: {launches} {by_route}")
    idx = keep["index"]
    L, b = res["search_size"], res["batch"]
    q, cq, seeds = _code_walk(torch, idx, keep["queries"], b)
    st = idx.state
    args = (st.vectors, st.adjacency, q, L, 2, 0, idx.config.metric, seeds, True, cq)
    got = vamana_search.vamana_beam_search(*args)
    want = vamana_search.beam_search_plain(*args)
    if route == "bit":
        _k10_equal(torch, got, want, f"the {kind} cell's walk")
        err = 0.0
    else:
        from semadb_tpu_torch.vectorstore.store import pq_gather_distance

        ok = got.cand_ids >= 0
        ref = pq_gather_distance(cq.codes, got.cand_ids.clamp(min=0), cq.prepared, cq.prepared.shape[2])
        err = float((got.cand_dists - ref).abs()[ok].max())
        mag = float(cq.prepared.abs().max()) * cq.prepared.shape[1]
        same = float((got.cand_ids == want.cand_ids).float().mean())
        if err > ADC_RTOL * mag or same < 0.95:
            raise AssertionError(f"K10's ADC route on the {kind} cell: |err| {err:.3g}, {same:.4f} of the list equal")
    k10 = {"max_abs_err": err, **vo.k10_least_bytes(*args[:9], codes=cq),
           "shape": (f"the {kind} cell's query walk: B={b}, L={L}, W=2, R={idx.config.degree_bound}, "
                     f"{seeds.shape[1]} entry seeds, the ring; codes {tuple(cq.codes.shape)} "
                     f"{str(cq.codes.dtype).replace('torch.', '')}, prepared {tuple(cq.prepared.shape)}"),
           "ms": _device_ms(torch, functools.partial(vamana_search.vamana_beam_search, *args), runs=VAMANA_TIMED_RUNS,
                            kernel=vamana_search.KERNELS),
           "plain_ms": _median_call_ms(torch, functools.partial(vamana_search.beam_search_plain, *args), runs=3),
           "hops_per_query": float(want.hops.float().mean())}
    k10["bound_ms"] = _bound_ms(k10["bytes"])
    # K4 at the rerank: the list and the ring, the start node dropped
    pool = torch.cat([got.cand_ids, got.visited_ids], dim=1)
    pool = pool.masked_fill(pool == vamana_search.START_ID, -1).contiguous()
    coarse = torch.cat([got.cand_dists, got.visited_dists], dim=1).contiguous()
    ops = (st.vectors, q, pool, coarse, LIMIT, idx.config.metric, True)
    kgot = ivf_rerank.ivf_exact_rerank(*ops)
    kwant = ivf_rerank.ivf_exact_rerank_plain(*ops)
    kerr = check_rows(torch, kwant, kgot, _k4_dist_of(torch, st.vectors, q, idx.config.metric),
                      _k4_atol(torch, st.vectors, q), f"K4 at the {kind} cell's rerank")
    nbytes, rows = _k4_bytes(torch, st.vectors, q, pool, coarse, LIMIT)
    k4 = {"max_abs_err": kerr, "bytes": nbytes, "distinct_rows": rows, "bound_ms": _bound_ms(nbytes),
          "shape": f"the {kind} cell's rerank: B={b}, rr={pool.shape[1]} (L + V), k={LIMIT}, D={q.shape[1]}, dedup",
          "ms": _device_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank, *ops), runs=IVF_TIMED_RUNS,
                           kernel="rerank_kernel"),
          "plain_ms": _median_call_ms(torch, functools.partial(ivf_rerank.ivf_exact_rerank_plain, *ops), runs=3)}
    log(f"[{kind}-cell] recall@10 {res['recall@10']:.4f} (floor {floor}), QPS {res['qps']:.0f}, build "
        f"{res['build_s']:.2f} s (fit {res['build_split_s']['fit_s']:.3f} s); K10 {route} route at the cell's walk "
        f"{k10['ms']:.4f} ms (bound {k10['bound_ms']:.4f}, {k10['bound_ms'] / k10['ms']:.1%}), plain "
        f"{k10['plain_ms']:.2f} ms, {k10['hops_per_query']:.2f} hops a query, {k10['distinct_rows_scored']} distinct "
        f"rows of {k10['rows_scored']} scored; K4 at the rerank {k4['ms']:.4f} ms (bound {k4['bound_ms']:.4f}, "
        f"{k4['bound_ms'] / k4['ms']:.1%}), plain {k4['plain_ms']:.3f} ms; launches {launches}, K10 by route "
        f"{by_route}")
    del keep
    return {"res": res, "profile": prof, "launches": launches, "by_route": by_route, "k10": k10, "k4": k4}


def phase_vamana_pool_cell(torch, counted) -> dict:
    """The pool build (SEMADB_VAMANA_BUILD=pool) on the 1M cell: recall@10 at
    L = 75 (annbench) and at L = 40 on the same build, its seconds by stage
    and the peak device memory."""
    res, prof, launches, _, keep = _run_annbench(counted, VAMANA_POOL_ARGV, "pool-cell")
    if res["recall@10"] < VAMANA_POOL_RECALL:
        raise AssertionError(f"the pool build's recall@10 {res['recall@10']} at L = 75 is below {VAMANA_POOL_RECALL}")
    if launches["K11"] <= 0 or launches["K10"] <= 0:
        raise AssertionError(f"the pool cell did not run K11 and K10: {launches}")
    idx, gt, queries = keep["index"], keep["ground_truth"], keep["queries"]
    ids = np.empty((len(queries), LIMIT), np.int64)
    for lo in range(0, len(queries), res["batch"]):
        _, i = idx.search_batch(queries[lo : lo + res["batch"]], LIMIT, search_size=40)
        ids[lo : lo + len(i)] = i - 2
    r40 = float(np.mean([len(set(ids[j]) & set(gt[j])) / LIMIT for j in range(len(gt))]))
    if r40 < VAMANA_POOL_L40_RECALL:
        raise AssertionError(f"the pool build's recall@10 {r40} at L = 40 is below {VAMANA_POOL_L40_RECALL}")
    split = res["build_split_s"]
    log(f"[pool-cell] recall@10 {res['recall@10']:.4f} at L = 75, {r40:.4f} at L = 40; build {res['build_s']:.2f} s "
        f"(k-means {split['kmeans_s']:.2f}, pools {split['pools_s']:.2f}, pass 1 {split['pass1_s']:.2f}, pass 2 "
        f"{split.get('pass2.0_s', 0.0):.2f}, top-up {split['topup_s']:.3f}, lean {split['lean']}); peak device memory "
        f"{res.get('peak_mem_gib', float('nan')):.2f} GiB; launches {launches}")
    del keep
    return {"res": res, "recall_l40": r40, "launches": launches}


def phase_vamana_quant_http(torch, counted, device, seed: int, n_points: int = HTTP_QUANT_POINTS) -> dict:
    """Three v2 vectorVamana collections over the port's node and HTTP
    server, one shard each: a binary quantizer (hamming), a product
    quantizer (8 x 256) and the user hamming metric on 0/1 vectors. Searches
    and filtered searches against numpy (reranked distances f32 within 1e-5
    relative, raw bit counts exact), deletes and updates, a flush, close and
    reopen."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.ops.kernels import vamana_search
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like

    dim = HTTP_IVF_DIM
    ds = embedding_like(n_points + HTTP_VAMANA_WRITES, dim, HTTP_QUANT_QUERIES, spread=0.5, seed=seed + 20)
    rng = np.random.default_rng([seed, 20])
    bits = rng.integers(0, 2, (n_points + HTTP_VAMANA_WRITES + HTTP_QUANT_QUERIES, dim)).astype(np.float32)
    datasets = {"vbq": (ds.train[:n_points].copy(), ds.test, ds.train[n_points:]),
                "vpq": (ds.train[:n_points].copy(), ds.test, ds.train[n_points:]),
                "vham": (bits[:n_points].copy(), bits[-HTTP_QUANT_QUERIES:],
                         bits[n_points : n_points + HTTP_VAMANA_WRITES])}
    entries = {
        "vbq": {"distanceMetric": "euclidean", "quantizer": {"type": "binary", "binary": {
            "distanceMetric": "hamming", "triggerThreshold": 10000}}},
        "vpq": {"distanceMetric": "euclidean", "quantizer": {"type": "product", "product": {
            "numCentroids": 256, "numSubVectors": 8, "triggerThreshold": 10000}}},
        "vham": {"distanceMetric": "hamming"},
    }
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: i for i, pid in enumerate(ids)}
    tags = [f"t{i % 4}" for i in range(n_points)]
    order = rng.permutation(n_points)
    deleted = order[:HTTP_VAMANA_WRITES]
    moved = order[HTTP_VAMANA_WRITES : 2 * HTTP_VAMANA_WRITES]
    live = np.ones(n_points, bool)
    t1 = np.array([t == "t1" for t in tags])

    def truth_dist(name, data, qv):
        if name == "vham":
            return (data.astype(bool) != (qv > 0.5)).sum(-1).astype(np.float64)
        return ((data.astype(np.float64) - qv.astype(np.float64)) ** 2).sum(-1)

    def check(name, rows, flt=None) -> float:
        data, queries, _ = datasets[name]
        hits = 0
        for qv, row in zip(queries, rows):
            d = truth_dist(name, data, qv)
            ok = live.copy() if flt is None else live & flt
            got = [row_of[pid] for pid, _ in row]
            if any(not ok[r] for r in got):
                raise AssertionError(f"{name}: a deleted or filtered-out point came back")
            d[~ok] = np.inf
            truth = set(np.argsort(d, kind="stable")[:LIMIT].tolist())
            hits += len(truth & set(got))
            for (_, dist), r in zip(row, got):
                exact = name == "vham"
                if (dist != d[r]) if exact else abs(dist - d[r]) > VAMANA_RTOL * max(1.0, d[r]):
                    raise AssertionError(f"{name}: distance {dist} of a point at {d[r]}")
        return hits / (LIMIT * len(rows))

    def body(qv, flt=None):
        out = {"query": {"property": "vec", "vectorVamana": {"vector": qv.tolist(), "operator": "near",
                                                             "limit": LIMIT}}}
        if flt is not None:
            out["query"]["vectorVamana"]["filter"] = flt
        return out

    def searches(srv) -> dict:
        flt = {"property": "tag", "string": {"value": "t1", "operator": "equals"}}
        out = {}
        for name, (_, queries, _) in datasets.items():
            out[name] = [[(p["_id"], p["_distance"]) for p in bq.http_json(
                srv.base, "POST", f"/{name}/points/search", body(qv))["points"]] for qv in queries]
            out[name + "/filtered"] = [[(p["_id"], p["_distance"]) for p in bq.http_json(
                srv.base, "POST", f"/{name}/points/search", body(qv, flt))["points"]] for qv in queries]
        return out

    def check_all(res, what) -> dict:
        recall = {key: check(key.split("/")[0], rows, t1 if key.endswith("filtered") else None)
                  for key, rows in res.items()}
        # The bar holds the unfiltered BQ and PQ searches. A filtered walk
        # admits only the seeds and the expanded members (search.go:27-51,
        # the JAX package's search_filtered, held equal on the CPU): its
        # recall on codes is reported, not held (0.87-0.90 at 50 queries on
        # an H100); hamming ranks tie across many points
        low = {key: r for key, r in recall.items()
               if key in ("vbq", "vpq") and r < HTTP_QUANT_RECALL}
        if low:
            raise AssertionError(f"{what}: recall@10 {low} below {HTTP_QUANT_RECALL} (all: {recall})")
        return recall

    with tempfile.TemporaryDirectory(prefix="semadb_smoke_vamana_quant_") as root:
        cfg = bq.slice_config(root)
        _zero_counts(counted)
        with bq.serving(cfg, device) as srv:
            t0 = time.perf_counter()
            cols = {}
            for name, entry in entries.items():
                schema = {"vec": {"type": "vectorVamana", "vectorVamana": {"vectorSize": dim, **entry}},
                          "tag": {"type": "string", "string": {"caseSensitive": True}}}
                bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema})
                data = datasets[name][0]
                bq.http_json(srv.base, "POST", f"/{name}/points", {"points": [
                    {"_id": ids[i], "vec": data[i].tolist(), "tag": tags[i]} for i in range(1000)]})
                # Fetched after the first insert made its shard, so that the
                # rest go to that shard
                cols[name] = col = srv.node.get_collection(bq.USER["X-User-Id"], name)
                col.user_plan = srv.plan
                for lo in range(1000, n_points, 5000):
                    pts = [Point.from_map({"vec": data[i].tolist(), "tag": tags[i]}, uuid.UUID(ids[i]))
                           for i in range(lo, min(lo + 5000, n_points))]
                    failed = srv.node.insert_points(col, pts)
                    assert failed == [], failed
                if len(col.shard_ids) != 1:
                    raise AssertionError(f"{name}: {len(col.shard_ids)} shards, not one")
            ingest_s = time.perf_counter() - t0
            fitted = {name: srv.node.shard_manager.do_with_shard(
                col, col.shard_ids[0], lambda s: next(iter(s.device_indices.values())).store.fitted)
                for name, col in cols.items()}
            if not all(fitted.values()):
                raise AssertionError(f"a store is not fitted after {n_points} points: {fitted}")
            t0 = time.perf_counter()
            before = searches(srv)
            search_s = time.perf_counter() - t0
            recall = check_all(before, "before the writes")
            t0 = time.perf_counter()
            for name in entries:
                for lo in range(0, len(deleted), 100):
                    bq.http_json(srv.base, "DELETE", f"/{name}/points",
                                 {"ids": [ids[i] for i in deleted[lo : lo + 100]]})
                moved_to = datasets[name][2]
                for lo in range(0, len(moved), 100):
                    rows = list(enumerate(moved[lo : lo + 100], start=lo))
                    bq.http_json(srv.base, "PUT", f"/{name}/points", {"points": [
                        {"_id": ids[i], "vec": moved_to[j].tolist()} for j, i in rows]})
                datasets[name][0][moved] = moved_to
            live[deleted] = False
            writes_s = time.perf_counter() - t0
            after = searches(srv)
            recall_after = check_all(after, "after the writes")
            for name in entries:
                moved_to = datasets[name][2]
                for j, i in enumerate(moved[:20]):
                    top = bq.http_json(srv.base, "POST", f"/{name}/points/search", {"query": {
                        "property": "vec", "vectorVamana": {"vector": moved_to[j].tolist(), "operator": "near",
                                                            "limit": 1}}})["points"][0]
                    if top["_id"] != ids[i] or top["_distance"] != 0:
                        raise AssertionError(f"{name}: an updated point does not find itself: {top}")
            chunks = {name: sum(srv.node.shard_manager.do_with_shard(col, sid, lambda s: s.flush())
                                for sid in col.shard_ids) for name, col in cols.items()}
        launches = {nm: mod.LAUNCHES for nm, mod in counted}
        by_route = dict(vamana_search.LAUNCHES_BY)
        with bq.serving(cfg, device) as srv:
            reopened = searches(srv)
        if reopened != after:
            bad = [key for key in after if reopened[key] != after[key]]
            raise AssertionError(f"after close and reopen the searches {bad} answer otherwise")
    log(f"[vamana-quant-http] {n_points} points of {dim}-d into three v2 vectorVamana collections (BQ hamming, PQ "
        f"8 x 256, the hamming metric on 0/1 vectors; 1,000 each over HTTP) in {ingest_s:.2f} s, stores fitted; "
        f"{HTTP_QUANT_QUERIES} searches and {HTTP_QUANT_QUERIES} filtered of each: recall@10 {recall} against numpy (BQ and PQ reranked, f32 within 1e-5; "
        f"hamming bit counts exact) in {search_s:.2f} s; {HTTP_VAMANA_WRITES} deletes and {HTTP_VAMANA_WRITES} "
        f"updates a collection in {writes_s:.2f} s: recall@10 {recall_after}, no deleted id back, 20 updated points "
        f"each find themselves at 0; the flush wrote {chunks} chunks; after close and reopen every search answers "
        f"the same; launches {launches}, K10 by route {by_route}")
    if by_route.get("bit", 0) <= 0 or by_route.get("adc", 0) <= 0 or launches["K4"] <= 0:
        raise AssertionError(f"the quantized HTTP phase did not run K10's bit and ADC routes and K4: {launches} "
                             f"{by_route}")
    return {"recall": recall, "recall_after": recall_after, "launches": launches, "by_route": by_route}


# -- the mesh fan-out (shardPlacement "device") -------------------------------------

MESH_SHARDS = 8
MESH_ARGV = ("--n", "1000000", "--shards", str(MESH_SHARDS), "--data", "embedding", "--queries", "4096")
MESH_RUNS = 5  # timed mesh batches and host fan-outs, each, in turns
MESH_MERGE_RUNS = 20
HTTP_MESH_POINTS = 20_000
HTTP_MESH_QUERIES = 20
HTTP_MESH_RECALL = 0.9
MESH_VAMANA_OVERLAP = 0.98  # of the top-10 ids, mesh against the host fan-out (see phase_mesh_http)


def _host_fanout(indices, queries, p: int, k: int):
    """The host fan-out over a fleet: each shard's own search, then the merge
    on the host (numpy's lexsort over the shard-major [B, S*k] lists)."""
    outs = [idx.search_batch_async(queries, k, p) for idx in indices]
    d = np.concatenate([o[0].cpu().numpy() for o in outs], 1)
    i = np.concatenate([o[1].cpu().numpy() for o in outs], 1)
    s = np.repeat(np.arange(len(indices), dtype=np.int32), k)[None, :].repeat(d.shape[0], 0)
    order = np.lexsort((i, d), axis=-1)[:, :k]
    return tuple(np.take_along_axis(a, order, 1) for a in (d, i, s))


def phase_mesh_fleet(torch, counted, device, seed: int, spread: bool = False) -> dict:
    """``restackbench`` at its defaults' size, 1M points over 8 shards (an
    ``embedding_like`` fleet, 8 slots on ``device``, or with ``spread`` over
    every visible card in turn), then one mesh batch of
    4,096 queries at k = 10 and the shards' default probes against the host
    fan-out over the same shards: the mesh's result must equal the merge of
    each shard's own search by the tie rule (in practice bit for bit)."""
    from semadb_tpu_torch.ops.topk import tie_rule_errors
    from semadb_tpu_torch.parallel import fanout
    from semadb_tpu_torch.tools import restackbench

    keep = {}
    t0 = time.perf_counter()
    restackbench.main([*MESH_ARGV, "--device", str(device), *(("--spread",) if spread else ())], keep=keep)
    bench_s = time.perf_counter() - t0
    indices, stacked, mesh, test = keep["indices"], keep["stacked"], keep["mesh"], keep["test"]
    p, k = indices[0]._num_probes(0), LIMIT
    q = torch.from_numpy(test).to(device)
    B = q.shape[0]
    _zero_counts(counted)
    d, i, s = fanout.sharded_ivf_search(stacked, q, p, k, mesh)
    torch.cuda.synchronize()
    launches = {nm: mod.LAUNCHES for nm, mod in counted}
    if launches["K3"] < MESH_SHARDS or launches["K4"] < MESH_SHARDS:
        raise AssertionError(f"a mesh batch over {MESH_SHARDS} slots launched {launches}")
    md, mi, ms = d.cpu().numpy(), i.cpu().numpy(), s.cpu().numpy()
    hd, hi, hs = _host_fanout(indices, q, p, k)
    same = np.all(md == hd, 1) & np.all(mi == hi, 1) & np.all(ms == hs, 1)
    for b in np.nonzero(~same)[0]:
        qb = test[b].astype(np.float64)

        def dist_of(key, qb=qb):
            row = indices[key[0]].vectors[key[1]].cpu().numpy().astype(np.float64)
            return float(((row - qb) ** 2).sum())

        errs = tie_rule_errors(hd[b], list(zip(hs[b].tolist(), hi[b].tolist())), md[b],
                               list(zip(ms[b].tolist(), mi[b].tolist())), dist_of,
                               atol=IVF_RTOL * max(1.0, float(hd[b][-1])))
        if errs:
            raise AssertionError(f"mesh batch row {b} against the host fan-out: {errs[:3]}")
    equal_rows = int(same.sum())
    mesh_ms, host_ms = [], []
    for _ in range(MESH_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fanout.sharded_ivf_search(stacked, q, p, k, mesh)
        out[0].cpu()
        mesh_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        _host_fanout(indices, q, p, k)
        host_ms.append((time.perf_counter() - t1) * 1e3)
    per_slot = [fanout._ivf_slot(st, q, None, p, k, "euclidean") for st in stacked]
    sh = [torch.full_like(r[1], si) for si, r in enumerate(per_slot)]
    merge = functools.partial(fanout._allgather_topk, [r[0] for r in per_slot], [r[1] for r in per_slot], sh, k)
    merge_ms = _device_ms(torch, merge, runs=MESH_MERGE_RUNS)
    merge_call_ms = _median_call_ms(torch, merge)
    merge_bytes = 3 * B * MESH_SHARDS * k * 4 + 3 * B * k * 4  # three [B, S*k] lists in, three [B, k] out
    res = {
        "shards": MESH_SHARDS, "points": sum(len(idx) for idx in indices), "B": B, "k": k, "probes": p,
        "bench_s": bench_s,
        "build_s": keep["build_s"], "full_restack_s": keep["full_restack_s"],
        "incremental_s": keep["incremental_s"], "mesh_ms": float(np.median(mesh_ms)),
        "host_ms": float(np.median(host_ms)), "mesh_qps": B / (np.median(mesh_ms) / 1e3),
        "host_qps": B / (np.median(host_ms) / 1e3), "merge_ms": merge_ms, "merge_call_ms": merge_call_ms,
        "merge_bound_ms": _bound_ms(merge_bytes), "equal_rows": equal_rows, "launches": launches,
    }
    log(f"[mesh-fleet] restackbench {' '.join(MESH_ARGV)} in {bench_s:.1f} s (build {keep['build_s']:.1f} s): "
        f"full restack {keep['full_restack_s']} s, incremental {keep['incremental_s']} s")
    log(f"[mesh-fleet] {res['points']} points in {MESH_SHARDS} shards on {mesh.size} slots over {sorted(set(map(str, mesh.slots)))}; "
        f"B={B}, k={k}, p={p}: mesh batch {res['mesh_ms']} ms ({res['mesh_qps']} QPS), host fan-out "
        f"{res['host_ms']} ms ({res['host_qps']} QPS), medians of {MESH_RUNS} (all: {mesh_ms} / {host_ms}); "
        f"{equal_rows} of {B} rows equal to the host fan-out bit for bit, the rest by the tie rule; merge "
        f"{merge_ms} ms on the device ({merge_call_ms} ms a call, bound {res['merge_bound_ms']}); launches {launches}")
    return res


def phase_mesh_http(torch, counted, device, seed: int, n_points: int = HTTP_MESH_POINTS, cards: int = 0) -> dict:
    """A node on ``device`` with an 8-slot mesh over it (or, with ``cards``,
    one slot on each of the first ``cards`` cards); over HTTP v2, one
    ``shardPlacement: "device"`` collection each of vectorIVF, vectorVamana,
    vectorFused and IVF-PQ (a shard a slot). Every search must be served by the
    mesh (a fall-back to the host fan-out fails the phase), launch K3/K4, K10,
    and K9, and answer as the host fan-out over the same shards (the mesh
    switched off): equal by the tie rule for IVF, IVF-PQ and fused; for
    Vamana the mesh walks from the start node where a shard's own search
    seeds from its entry spread (the JAX package's two planes alike), so the
    share of equal top-10 ids is held at MESH_VAMANA_OVERLAP and both
    recalls at HTTP_MESH_RECALL. Then a filtered query, and a write followed
    by a search that takes the incremental restack."""
    import uuid

    from semadb_tpu_torch.models import Point
    from semadb_tpu_torch.ops.kernels import ivf_pq_scan, vamana_search
    from semadb_tpu_torch.ops.topk import tie_rule_errors
    from semadb_tpu_torch.parallel.mesh import shard_mesh
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like, embedding_like_views

    dim = HTTP_IVF_DIM
    ds = embedding_like(n_points, dim, HTTP_MESH_QUERIES, spread=0.5, seed=seed + 22)
    v1, v2 = embedding_like_views(n_points, list(HTTP_VIEWS), HTTP_MESH_QUERIES, seed=seed + 23)
    rng = np.random.default_rng([seed, 22])
    ids = [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n_points)]
    row_of = {pid: r for r, pid in enumerate(ids)}
    grp = np.arange(n_points) % 3
    pq = {"type": "product", "product": {"numCentroids": 256, "numSubVectors": 8, "triggerThreshold": 1000}}
    kinds = {
        "mivf": ("emb", "vectorIVF", {"type": "vectorIVF", "vectorIVF": {"vectorSize": dim,
                                                                       "distanceMetric": "euclidean"}}),
        "mvam": ("emb", "vectorVamana", {"type": "vectorVamana", "vectorVamana": {
            "vectorSize": dim, "distanceMetric": "euclidean"}}),
        "mfused": ("emb", "vectorFused", {"type": "vectorFused", "vectorFused": {"views": [
            {"vectorSize": HTTP_VIEWS[0], "distanceMetric": "euclidean", "weight": 0.7},
            {"vectorSize": HTTP_VIEWS[1], "distanceMetric": "euclidean", "weight": 0.3}]}}),
        "mpq": ("emb", "vectorIVF", {"type": "vectorIVF", "vectorIVF": {"vectorSize": dim,
                                                                       "distanceMetric": "euclidean", "quantizer": pq}}),
    }
    x = ds.train.astype(np.float64)
    f1, f2 = v1.train.astype(np.float64), v2.train.astype(np.float64)

    def truth(name, qi):
        if name == "mfused":
            return (0.7 * ((f1 - v1.test[qi].astype(np.float64)) ** 2).sum(-1)
                    + 0.3 * ((f2 - v2.test[qi].astype(np.float64)) ** 2).sum(-1))
        return ((x - ds.test[qi].astype(np.float64)) ** 2).sum(-1)

    def body(name, qi, flt=None):
        key = kinds[name][1]
        vq = ({"vectors": [v1.test[qi].tolist(), v2.test[qi].tolist()]} if name == "mfused"
              else {"vector": ds.test[qi].tolist()})
        vq.update(operator="near", limit=LIMIT)
        if flt is not None:
            vq["filter"] = flt
        return {"query": {"property": "emb", key: vq}, "limit": LIMIT}

    mesh = shard_mesh(cards) if cards else shard_mesh(devices=[device] * MESH_SHARDS)
    out = {"p50_ms": {}, "recall": {}, "equal": {}}
    with tempfile.TemporaryDirectory(prefix="semadb_smoke_mesh_") as root:
        cfg = bq.slice_config(root)
        with bq.serving(cfg, device, mesh=mesh) as srv:
            node, ms = srv.node, srv.node._mesh()
            served, fallbacks = [], []
            orig_try = node._try_mesh_search

            def watched(col, srs):
                got = orig_try(col, srs)
                (served if got is not None else fallbacks).append(col.id)
                return got

            node._try_mesh_search = watched
            cols = {}
            t0 = time.perf_counter()
            for name, (prop, _, entry) in kinds.items():
                schema = {prop: entry, "grp": {"type": "integer", "integer": {}}}
                res = bq.http_json(srv.base, "POST", "", {"id": name, "indexSchema": schema,
                                                          "shardPlacement": "device"})
                assert res == {"message": "collection created"}, res
                col = node.get_collection(bq.USER["X-User-Id"], name)
                col.user_plan = srv.plan
                # One call: each shard takes its share at once, so its first
                # fit is past the product quantizer's trigger
                pts = [Point.from_map({prop: ([v1.train[r].tolist(), v2.train[r].tolist()] if name == "mfused"
                                              else ds.train[r].tolist()), "grp": int(grp[r])}, uuid.UUID(ids[r]))
                       for r in range(n_points)]
                assert node.insert_points(col, pts) == []
                col = node.get_collection(bq.USER["X-User-Id"], name)
                col.user_plan = srv.plan
                if len(col.shard_ids) != mesh.size:
                    raise AssertionError(f"{name}: {len(col.shard_ids)} shards, not one a slot")
                cols[name] = col
            ingest_s = time.perf_counter() - t0
            pq_on = [node.shard_manager.do_with_shard(cols["mpq"], sid, lambda sh: next(
                iter(sh.device_indices.values())).pq_active) for sid in cols["mpq"].shard_ids]
            if not all(pq_on):
                raise AssertionError(f"IVF-PQ: the quantizer fit on {sum(pq_on)} of {mesh.size} shards")
            for name in kinds:  # the first search of each builds its stack
                bq.http_json(srv.base, "POST", f"/{name}/points/search", body(name, 0))
            _zero_counts(counted)
            served.clear()
            mesh_rows = {name: [] for name in kinds}
            for name in kinds:
                lat = []
                for qi in range(HTTP_MESH_QUERIES):
                    t1 = time.perf_counter()
                    res = bq.http_json(srv.base, "POST", f"/{name}/points/search", body(name, qi))
                    lat.append((time.perf_counter() - t1) * 1e3)
                    mesh_rows[name].append([(p["_id"], p["_distance"]) for p in res["points"]])
                out["p50_ms"][name] = {"mesh": float(np.median(lat))}
            launches = {nm: mod.LAUNCHES for nm, mod in counted}
            by_route = dict(vamana_search.LAUNCHES_BY)
            k9_by_entry = dict(ivf_pq_scan.LAUNCHES_BY)
            if fallbacks or len(served) != len(kinds) * HTTP_MESH_QUERIES:
                raise AssertionError(f"searches fell back to the host fan-out: {fallbacks}; served {len(served)}")
            if launches["K3"] <= 0 or launches["K4"] <= 0 or by_route.get("f32", 0) <= 0 or \
                    k9_by_entry.get("probed", 0) <= 0:
                raise AssertionError(f"the mesh searches did not launch K3, K4, K10 and K9: {launches}, "
                                     f"K10 {by_route}, K9 {k9_by_entry}")
            # The host fan-out over the same shards: the mesh switched off
            node._mesh_searcher = None
            host_rows = {name: [] for name in kinds}
            for name in kinds:
                lat = []
                for qi in range(HTTP_MESH_QUERIES):
                    t1 = time.perf_counter()
                    res = bq.http_json(srv.base, "POST", f"/{name}/points/search", body(name, qi))
                    lat.append((time.perf_counter() - t1) * 1e3)
                    host_rows[name].append([(p["_id"], p["_distance"]) for p in res["points"]])
                out["p50_ms"][name]["host"] = float(np.median(lat))
            node._mesh_searcher = ms
            fallbacks.clear()  # the host fan-out's own searches, made on purpose
            for name in kinds:
                hits_m = hits_h = same = 0
                for qi, (mrow, hrow) in enumerate(zip(mesh_rows[name], host_rows[name])):
                    dist = truth(name, qi)
                    top = set(np.argsort(dist, kind="stable")[:LIMIT].tolist())
                    hits_m += len(top & {row_of[pid] for pid, _ in mrow})
                    hits_h += len(top & {row_of[pid] for pid, _ in hrow})
                    same += len({pid for pid, _ in mrow} & {pid for pid, _ in hrow})
                    for pid, dd in mrow:
                        if abs(dd - dist[row_of[pid]]) > 1e-4 * max(1.0, abs(dist[row_of[pid]])):
                            raise AssertionError(f"{name}: mesh distance {dd} of a point at {dist[row_of[pid]]}")
                    if name != "mvam":
                        errs = tie_rule_errors([dd for _, dd in hrow], [pid for pid, _ in hrow],
                                               [dd for _, dd in mrow], [pid for pid, _ in mrow],
                                               lambda pid: dist[row_of[pid]],
                                               atol=1e-4 * max(1.0, float(np.abs(dist).max())))
                        if errs:
                            raise AssertionError(f"{name}: the mesh against the host fan-out, query {qi}: {errs[:3]}")
                n = LIMIT * HTTP_MESH_QUERIES
                out["recall"][name] = {"mesh": hits_m / n, "host": hits_h / n}
                out["equal"][name] = same / n
                if min(hits_m, hits_h) / n < HTTP_MESH_RECALL:
                    raise AssertionError(f"{name}: recall@10 {out['recall'][name]} below {HTTP_MESH_RECALL}")
            if out["equal"]["mvam"] < MESH_VAMANA_OVERLAP:
                raise AssertionError(f"vectorVamana: {out['equal']['mvam']} of the mesh's ids are the host's")
            # One filtered query on each f32 kind, mesh-served, every hit in the filter
            flt = {"property": "grp", "integer": {"value": 1, "operator": "equals"}}
            served.clear()
            for name in ("mivf", "mvam", "mfused"):
                res = bq.http_json(srv.base, "POST", f"/{name}/points/search", body(name, 1, flt))
                rows = [row_of[p["_id"]] for p in res["points"]]
                if len(rows) != LIMIT or any(grp[r] != 1 for r in rows):
                    raise AssertionError(f"{name}: a filtered search returned {rows}")
            if len(served) != 3 or fallbacks:
                raise AssertionError(f"the filtered searches were not mesh-served: {served}, {fallbacks}")
            # One write, then a search that takes the incremental restack
            rebuilds, incrementals = [], []
            orig_build, orig_incr = ms._build_from, ms._try_incremental
            ms._build_from = lambda *a, **kw: rebuilds.append(1) or orig_build(*a, **kw)

            def incr(*a, **kw):
                got = orig_incr(*a, **kw)
                if got is not None:
                    incrementals.append(1)
                return got

            ms._try_incremental = incr
            new_id = str(uuid.UUID(bytes=rng.bytes(16), version=4))
            newv = ds.test[2] + 1e-3
            res = bq.http_json(srv.base, "POST", "/mivf/points", {"points": [{"_id": new_id, "emb": newv.tolist(),
                                                                            "grp": 0}]})
            t1 = time.perf_counter()
            res = bq.http_json(srv.base, "POST", "/mivf/points/search", body("mivf", 2))
            restack_search_ms = (time.perf_counter() - t1) * 1e3
            if res["points"][0]["_id"] != new_id or rebuilds or not incrementals:
                raise AssertionError(f"the write: first hit {res['points'][0]['_id']}, rebuilds {len(rebuilds)}, "
                                     f"incremental restacks {len(incrementals)}")
            out.update(ingest_s=ingest_s, launches=launches, k10_by_route=by_route, k9_by_entry=k9_by_entry,
                       restack_search_ms=restack_search_ms, served=len(served))
    log(f"[mesh-http] {len(kinds)} collections of {n_points} points, {mesh.size} shards each on a mesh over "
        f"{[str(d) for d in mesh.slots]}, ingested in {ingest_s:.1f} s; {HTTP_MESH_QUERIES} HTTP searches each, every one mesh-served: "
        f"p50 ms {out['p50_ms']}; recall@10 {out['recall']}; top-10 ids shared with the host fan-out "
        f"{out['equal']}; launches {launches}, K10 {by_route}, K9 {k9_by_entry}; a write then a search on the "
        f"incremental restack in {restack_search_ms:.2f} ms")
    return out


def _k10_route_row(cell: dict, qhttp: dict, vcodes: dict) -> dict:
    """The kernels line's row of one of K10's quantized routes, from its
    cell's run (``cell``) and the HTTP phase's launches."""
    route = "bit" if "bit" in cell["by_route"] else "adc"
    k10 = cell["k10"]
    return {
        "name": (f"K10 vamana_beam_search, the {route} route ({'packed bits, hamming/jaccard, a lane a row, a whole '
                 'row a 16-byte load' if route == 'bit' else 'PQ codes through ADC tables staged in shared memory, '
                 'a lane a row'})"),
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/vamana_search.cu",
        "replaces": "semadb_tpu/ops/distance.py:154" if route == "bit" else "semadb_tpu/vectorstore/store.py:316",
        "launches": cell["by_route"][route],
        "max_abs_err": k10["max_abs_err"] if route == "bit" else max(k10["max_abs_err"], vcodes["adc_real_err"]),
        **{key: k10[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": None,
        "library": LIBRARY_NONE_K10_CODES,
        "shape": k10["shape"] + f"; device time per call, mean of {VAMANA_TIMED_RUNS}",
        "bound_bytes": k10["bytes"],
        **{key: k10[key] for key in ("distinct_rows_scored", "rows_scored", "distinct_nodes_expanded",
                                     "nodes_expanded", "hops_per_query")},
        "launches_http": qhttp["by_route"].get(route, 0),
        "checked_calls": vcodes["calls"],
        "cell": {key: cell["res"][key] for key in ("recall@10", "qps", "build_s", "search_size") if key in cell["res"]},
    }


def run_phase_22(torch, counted, device, args) -> tuple:
    """Phase 22's two parts, on one card or across ``--mesh-cards``."""
    cards = args.mesh_cards
    if cards and torch.cuda.device_count() < cards:
        raise RuntimeError(f"--mesh-cards {cards}: {torch.cuda.device_count()} cards visible")
    fleet = _phase("22 the mesh fan-out at 1M x 8", phase_mesh_fleet, torch, counted, device, args.seed,
                   spread=bool(cards))
    torch.cuda.empty_cache()
    http = _phase("22 the mesh fan-out over HTTP", phase_mesh_http, torch, counted, device, args.seed, cards=cards)
    return fleet, http


# -- phase 23: the three-node cluster ------------------------------------------

CLUSTER_POINTS = 20_000  # the IVF and Vamana collections, and each collection of the sync step
CLUSTER_DIM = 128
CLUSTER_QUERIES = 10  # IVF and Vamana searches through each node
CLUSTER_RECALL = 0.95
CLUSTER_REQUEST = 10_000  # points an insert request (the v2 limit)
CLUSTER_CLIENTS = 8
CLUSTER_SECONDS = 20.0
CLUSTER_TXN = 20  # points an insert txn of the concurrent clients
CLUSTER_POOL = 5_000  # new points the concurrent clients may insert into a collection
CLUSTER_SELF_BATCH = 1_024  # self-searches a batch request, after the concurrent clients
CLUSTER_SYNC_TRIES = 5  # collections the sync step fills until a shard belongs to another node
CLUSTER_BUDGET_SHARE = 0.5  # of one node's BQ indices' bytes: the in-process budget
CLUSTER_BUDGET_QUERIES = 5
CLUSTER_KERNELS = ("K1", "K3", "K4", "K10", "K11")  # the kernels of the cluster's path
CLUSTER_USER = "smoke"


def _mp(url: str, method: str = "POST", body=None, packed: bytes = None) -> dict:
    """One HTTP v2 request in msgpack, body and answer; raises on a status
    other than 200."""
    import urllib.error
    import urllib.request

    import msgpack

    data = packed if packed is not None else (None if body is None else _pack(body))
    headers = {"X-User-Id": CLUSTER_USER, "X-Plan-Id": "BASIC", "Accept": "application/msgpack"}
    if data is not None:
        headers["Content-Type"] = "application/msgpack"
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return msgpack.unpackb(r.read(), raw=False)
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{method} {url}: HTTP {e.code} {msgpack.unpackb(e.read(), raw=False)}") from e


def _pack(body) -> bytes:
    import msgpack

    return msgpack.packb(body, use_bin_type=True, use_single_float=True)  # the vectors' f32 values, exactly


def _seeded_ids(rng, n: int) -> list:
    import uuid

    return [str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in range(n)]


def _cluster_insert(base: str, name: str, ids, rows) -> None:
    """``rows`` into collection ``name`` through ``base`` in requests of
    CLUSTER_REQUEST points; the next request's body is packed while one is
    in flight."""
    def body(lo):
        hi = min(lo + CLUSTER_REQUEST, len(ids))
        return _pack({"points": [{"_id": pid, "vector": v} for pid, v in zip(ids[lo:hi], rows[lo:hi].tolist())]})

    starts = list(range(0, len(ids), CLUSTER_REQUEST))
    with ThreadPoolExecutor(1) as ex:
        nxt = ex.submit(body, starts[0])
        for i in range(len(starts)):
            blob = nxt.result()
            if i + 1 < len(starts):
                nxt = ex.submit(body, starts[i + 1])
            out = _mp(f"{base}/v2/collections/{name}/points", packed=blob)
            if out.get("failedRanges") != []:
                raise AssertionError(f"insert into {name} through {base}: {out}")


def _vector_body(kind: str, q, limit: int = LIMIT) -> dict:
    return {"query": {"property": "vector", kind: {"vector": q.tolist(), "operator": "near", "limit": limit}}}


def _shards_by_node(cl, name: str, shard_ids) -> dict:
    """Which node's root directory holds each shard of collection ``name``."""
    where = {}
    for n in cl.nodes:
        for sid in shard_ids:
            if os.path.exists(os.path.join(n.root, CLUSTER_USER, name, sid, "sharddb.sdb")):
                where.setdefault(sid, []).append(n.name)
    return where


def _compute_apps(torch, cl) -> dict:
    """Each node process's device memory as ``nvidia-smi`` lists it ("not
    listed" where it shows no such process, as in a container), and the
    card's memory in use by every process."""
    rows = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    by_pid = {int(r.split(",")[0]): r.split(",")[1].strip() for r in rows if r.split(",")[0].strip().isdigit()}
    free, total = torch.cuda.mem_get_info()
    return {**{n.name: by_pid.get(n.proc.pid, "not listed") for n in cl.nodes},
            "card_in_use_gib": (total - free) / 2**30}


def _vector_answers(base: str, name: str, kind: str, queries) -> tuple:
    """(each query's [(id, distance)], each search's seconds) through ``base``."""
    rows, lat = [], []
    for q in queries:
        t0 = time.perf_counter()
        pts = _mp(f"{base}/v2/collections/{name}/points/search", body=_vector_body(kind, q))["points"]
        lat.append(time.perf_counter() - t0)
        rows.append([(p["_id"], p["_distance"]) for p in pts])
    return rows, lat


def _check_vector_rows(rows, data, queries, row_of, what: str) -> float:
    """recall@10 of ``rows`` against numpy's exact search over ``data``, every
    distance numpy's within 1e-5 relative; returns the recall."""
    hits = 0
    for q, row in zip(queries, rows):
        d = ((data.astype(np.float64) - q.astype(np.float64)) ** 2).sum(-1)
        truth = set(np.argsort(d, kind="stable")[:LIMIT].tolist())
        got = [row_of[pid] for pid, _ in row]
        hits += len(truth & set(got))
        for (_, dist), r in zip(row, got):
            if abs(dist - d[r]) > VAMANA_RTOL * max(1.0, d[r]):
                raise AssertionError(f"{what}: distance {dist} of a point at {d[r]}")
    recall = hits / (LIMIT * len(rows))
    if recall < CLUSTER_RECALL:
        raise AssertionError(f"{what}: recall@10 {recall} is below {CLUSTER_RECALL}")
    return recall


def _cluster_launches(cl) -> dict:
    """The kernel launches of every node, from the logs of their last
    shutdown, and their sum."""
    by_node = {n.name: n.launches() for n in cl.nodes}
    total = {k: sum(v[k] for v in by_node.values()) for k in next(iter(by_node.values()))}
    return {"by_node": by_node, "total": total}


def _stop_cluster(cl) -> dict:
    """Stop every node; each must exit 0 (a node that died before fails)."""
    rcs = cl.stop()
    if any(rc != 0 for rc in rcs):
        raise AssertionError(f"node exit codes {rcs}:\n" + "\n".join(n.log_tail(20) for n in cl.nodes))
    return _cluster_launches(cl)


def _cluster_ingest(torch, cl, seed: int) -> dict:
    """Phase 23.1: the BQ collection through A, the IVF and Vamana
    collections through B, filled through C."""
    from semadb_tpu_torch.tools import dbpedia_bq as bq
    from semadb_tpu_torch.tools.datasets import embedding_like

    a, b, c = cl.nodes
    out = _mp(f"{a.http}/v2/collections", body={"id": bq.COLLECTION, "indexSchema": bq.SCHEMA})
    assert out == {"message": "collection created"}, out
    emb = bq.Embeddings(seed)
    ids = _seeded_ids(np.random.default_rng([seed, 23]), bq.N_POINTS)
    words = np.empty((bq.N_POINTS, bq.DIM // 64), np.uint64)
    t0 = time.perf_counter()
    for bi, lo in enumerate(range(0, bq.N_POINTS, CLUSTER_REQUEST)):
        v = emb.block(bi, CLUSTER_REQUEST)
        words[lo:lo + CLUSTER_REQUEST] = bq.sign_words(v)
        _cluster_insert(a.http, bq.COLLECTION, ids[lo:lo + CLUSTER_REQUEST], v)
    ingest_s = time.perf_counter() - t0
    info = _mp(f"{a.http}/v2/collections/{bq.COLLECTION}", method="GET")
    counts = {s["id"]: s["pointCount"] for s in info["shards"]}
    assert sum(counts.values()) == bq.N_POINTS, counts
    where = _shards_by_node(cl, bq.COLLECTION, counts)
    if sorted(where) != sorted(counts) or any(len(v) != 1 for v in where.values()):
        raise AssertionError(f"each BQ shard must lie in one node's directory: {where}")
    per_node = {n.name: sorted(counts[s] for s, owner in where.items() if owner == [n.name]) for n in cl.nodes}
    if sum(1 for v in per_node.values() if v) < 2:
        raise AssertionError(f"the BQ shards lie on one node, so no search crosses the RPC plane: {per_node}")
    log(f"[cluster] BQ: {bq.N_POINTS} x {bq.DIM} points over HTTP msgpack through {a.name} in {ingest_s:.2f} s = "
        f"{bq.N_POINTS / ingest_s:.1f} points/s; {len(counts)} shards, points per shard by node {per_node}")
    small = {}
    for kind, schema_kind, offset in (("ivf", "vectorIVF", 23), ("vamana", "vectorVamana", 24)):
        ds = embedding_like(CLUSTER_POINTS + CLUSTER_POOL, CLUSTER_DIM, CLUSTER_QUERIES, spread=0.5,
                            seed=seed + offset)
        sids = _seeded_ids(np.random.default_rng([seed, offset]), CLUSTER_POINTS + CLUSTER_POOL)
        out = _mp(f"{b.http}/v2/collections", body={"id": kind, "indexSchema": {"vector": {
            "type": schema_kind, schema_kind: {"vectorSize": CLUSTER_DIM, "distanceMetric": "euclidean"}}}})
        assert out == {"message": "collection created"}, out
        t1 = time.perf_counter()
        _cluster_insert(c.http, kind, sids[:CLUSTER_POINTS], ds.train[:CLUSTER_POINTS])
        took = time.perf_counter() - t1
        shards = [s["id"] for s in _mp(f"{c.http}/v2/collections/{kind}", method="GET")["shards"]]
        small[kind] = {"kind": schema_kind, "data": ds.train[:CLUSTER_POINTS], "pool": ds.train[CLUSTER_POINTS:],
                       "queries": ds.test, "ids": sids, "row_of": {pid: i for i, pid in enumerate(sids)},
                       "shards": _shards_by_node(cl, kind, shards)}
        log(f"[cluster] {schema_kind}: created through {b.name}, {CLUSTER_POINTS} x {CLUSTER_DIM} points through "
            f"{c.name} in {took:.2f} s = {CLUSTER_POINTS / took:.1f} points/s; shards {small[kind]['shards']}")
    memory = _compute_apps(torch, cl)
    log(f"[cluster] device memory by node (nvidia-smi --query-compute-apps): {memory}")
    data = bq.Loaded(ids, words, list(counts.values()), "", ingest_s, 0.0, 0.0, ingest_s)
    return {"bq": data, "per_node": per_node, "small": small, "ingest_points_per_s": bq.N_POINTS / ingest_s,
            "memory": memory}


def _cluster_answers(cl, ing: dict, seed: int) -> dict:
    """Phase 23.2: BQ, IVF and Vamana searches through every node."""
    from semadb_tpu_torch.tools import dbpedia_bq as bq

    queries = bq.queries(seed, 10 + 64)
    p50, recall = {}, {}
    ids_by_node = {}
    for n in cl.nodes:
        lat = []
        for i in range(10):
            t0 = time.perf_counter()
            pts = _mp(f"{n.http}/v2/collections/{bq.COLLECTION}/points/search",
                      body=bq.search_body(queries[i], LIMIT))["points"]
            lat.append(time.perf_counter() - t0)
            errs = bq.brute_force_errors(queries[i], pts, ing["bq"], LIMIT)
            if errs:
                raise AssertionError(f"BQ single search {i} through {n.name}: {errs}")
        t0 = time.perf_counter()
        res = _mp(f"{n.http}/v2/collections/{bq.COLLECTION}/points/search/batch",
                  body={"queries": [bq.search_body(q, LIMIT) for q in queries[10:]]})["results"]
        batch_ms = (time.perf_counter() - t0) * 1e3
        for i, row in enumerate(res):
            errs = bq.brute_force_errors(queries[10 + i], row["points"], ing["bq"], LIMIT)
            if errs:
                raise AssertionError(f"BQ batch search {i} through {n.name}: {errs}")
        p50[n.name] = {"bq": float(np.median(lat)) * 1e3, "bq_batch64": batch_ms}
        recall[n.name] = {}
        for kind, s in ing["small"].items():
            rows, lat = _vector_answers(n.http, kind, s["kind"], s["queries"])
            recall[n.name][kind] = _check_vector_rows(rows, s["data"], s["queries"], s["row_of"],
                                                      f"{s['kind']} through {n.name}")
            p50[n.name][kind] = float(np.median(lat)) * 1e3
            ids_by_node.setdefault(kind, {})[n.name] = [[pid for pid, _ in row] for row in rows]
    for kind, by in ids_by_node.items():
        first = next(iter(by.values()))
        if any(v != first for v in by.values()):
            raise AssertionError(f"{kind}: the nodes answered different ids")
    log(f"[cluster] every node: 10 BQ single searches and a batch of 64 equal to numpy brute force by the tie rule; "
        f"{CLUSTER_QUERIES} IVF and Vamana searches each, recall@10 {recall}, the same ids from all three; "
        f"HTTP p50 ms by node and kind {p50}")
    return {"p50_ms": p50, "recall": recall}


def _cluster_concurrent(cl, ing: dict, seed: int) -> dict:
    """Phase 23.3: CLUSTER_CLIENTS threads for CLUSTER_SECONDS, each request to
    a node drawn at random: single searches of the three collections and
    insert txns into IVF and Vamana. No request may fail; then every
    acknowledged point must come back through every node as its own nearest
    neighbour."""
    import threading

    from semadb_tpu_torch.tools import dbpedia_bq as bq

    bq_queries = bq.queries(seed + 5, 64)
    lock = threading.Lock()
    taken = {k: 0 for k in ing["small"]}
    acked = {k: [] for k in ing["small"]}
    counts, failures, lat = {}, [], {}
    known = {k: set(s["ids"]) for k, s in ing["small"].items()}
    end = time.perf_counter() + CLUSTER_SECONDS

    def one(rng):
        node = cl.nodes[int(rng.integers(len(cl.nodes)))]
        r = float(rng.random())
        kinds = list(ing["small"])
        kind = kinds[int(rng.integers(len(kinds)))]
        s = ing["small"][kind]
        if r >= 0.6:
            with lock:
                lo = taken[kind]
                if lo + CLUSTER_TXN <= CLUSTER_POOL:
                    taken[kind] = lo + CLUSTER_TXN
            if lo + CLUSTER_TXN <= CLUSTER_POOL:
                ids = s["ids"][CLUSTER_POINTS + lo:CLUSTER_POINTS + lo + CLUSTER_TXN]
                out = _mp(f"{node.http}/v2/collections/{kind}/points", body={"points": [
                    {"_id": pid, "vector": v} for pid, v in zip(ids, s["pool"][lo:lo + CLUSTER_TXN].tolist())]})
                if out.get("failedRanges") != []:
                    raise AssertionError(f"insert txn into {kind} through {node.name}: {out}")
                with lock:
                    acked[kind].append(lo)
                return f"{kind}_insert"
            r = 0.0  # the pool is used up: a search instead
        if r < 0.2:
            i = int(rng.integers(len(bq_queries)))
            pts = _mp(f"{node.http}/v2/collections/{bq.COLLECTION}/points/search",
                      body=bq.search_body(bq_queries[i], LIMIT))["points"]
            errs = bq.brute_force_errors(bq_queries[i], pts, ing["bq"], LIMIT)
            if errs:
                raise AssertionError(f"BQ search through {node.name}: {errs}")
            return "bq_search"
        q = s["queries"][int(rng.integers(len(s["queries"])))]
        pts = _mp(f"{node.http}/v2/collections/{kind}/points/search", body=_vector_body(s["kind"], q))["points"]
        if len(pts) != LIMIT or any(p["_id"] not in known[kind] or not np.isfinite(p["_distance"]) for p in pts):
            raise AssertionError(f"{kind} search through {node.name} during writes: {pts}")
        return f"{kind}_search"

    def client(t):
        rng = np.random.default_rng([seed, 230, t])
        while time.perf_counter() < end:
            t0 = time.perf_counter()
            try:
                what = one(rng)
            except Exception as e:  # every failure is counted and fails the phase below
                with lock:
                    failures.append(f"client {t}: {type(e).__name__}: {e}")
                continue
            with lock:
                counts[what] = counts.get(what, 0) + 1
                lat.setdefault(what, []).append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(CLUSTER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cl.check()
    if failures:
        raise AssertionError(f"{len(failures)} requests failed under {CLUSTER_CLIENTS} clients: {failures[:5]}")
    found = {}
    for kind, s in ing["small"].items():
        rows = sorted(lo + j for lo in acked[kind] for j in range(CLUSTER_TXN))
        for n in cl.nodes:
            for at in range(0, len(rows), CLUSTER_SELF_BATCH):
                part = rows[at:at + CLUSTER_SELF_BATCH]
                res = _mp(f"{n.http}/v2/collections/{kind}/points/search/batch", body={"queries": [
                    _vector_body(s["kind"], s["pool"][r], 1) for r in part]})["results"]
                for r, row in zip(part, res):
                    pts = row["points"]
                    if not pts or pts[0]["_id"] != s["ids"][CLUSTER_POINTS + r] or pts[0]["_distance"] != 0.0:
                        raise AssertionError(f"{kind}: acknowledged point {r} through {n.name} came back as {pts}")
        found[kind] = len(rows)
    p50 = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
    log(f"[cluster] {CLUSTER_CLIENTS} clients for {CLUSTER_SECONDS:.0f} s over the three nodes: requests {counts}, "
        f"none failed; p50 ms {p50}; every acknowledged point ({found}) came back through every node as its own "
        f"nearest neighbour at distance 0")
    return {"requests": counts, "failed": 0, "p50_ms": p50, "acknowledged": found}


def _cluster_sync(run_cluster, root: str, device, seed: int) -> dict:
    """Phase 23.4: serverA alone fills IVF collections; then A, B and C start
    with the published servers lists and A's startup sync ships the shards
    whose rendezvous owner is another node. The answers through every node
    must equal A's before the move."""
    from semadb_tpu_torch.cluster.hashing import rendezvous_hash
    from semadb_tpu_torch.tools.datasets import embedding_like

    full = run_cluster.prepare(run_cluster.CONFIGS, root)
    servers = [n.rpc for n in full.nodes]
    solo = run_cluster.launch(run_cluster.prepare(run_cluster.CONFIGS[:1], root, only_started=True), str(device))
    a = solo.nodes[0]
    before, shards, names = {}, {}, []
    with solo:
        for t in range(CLUSTER_SYNC_TRIES):
            name = f"synced{t}"
            ds = embedding_like(CLUSTER_POINTS, CLUSTER_DIM, CLUSTER_QUERIES, spread=0.5, seed=seed + 40 + t)
            ids = _seeded_ids(np.random.default_rng([seed, 40 + t]), CLUSTER_POINTS)
            out = _mp(f"{a.http}/v2/collections", body={"id": name, "indexSchema": {"vector": {
                "type": "vectorIVF", "vectorIVF": {"vectorSize": CLUSTER_DIM, "distanceMetric": "euclidean"}}}})
            assert out == {"message": "collection created"}, out
            _cluster_insert(a.http, name, ids, ds.train)
            shards[name] = [s["id"] for s in _mp(f"{a.http}/v2/collections/{name}", method="GET")["shards"]]
            before[name] = (ds.test, _vector_answers(a.http, name, "vectorIVF", ds.test)[0])
            _check_vector_rows(before[name][1], ds.train, ds.test, {p: i for i, p in enumerate(ids)},
                               f"{name} through {a.name} alone")
            names.append(name)
            owners = {sid: rendezvous_hash(sid, servers, 1)[0] for sid in shards[name]}
            if any(o != a.rpc for o in owners.values()):
                break
        launches_solo = _stop_cluster(solo)["total"]
    owners = {sid: rendezvous_hash(sid, servers, 1)[0] for name in names for sid in shards[name]}
    to_move = sorted(sid for sid, o in owners.items() if o != a.rpc)
    if not to_move:
        raise AssertionError(f"every shard of {CLUSTER_SYNC_TRIES} collections hashes to {a.name}: {owners}")
    full = run_cluster.prepare(run_cluster.CONFIGS, root)
    if [n.rpc for n in full.nodes] != servers:
        raise AssertionError(f"the ports moved between the two starts: {servers}, {[n.rpc for n in full.nodes]}")
    run_cluster.launch(full, str(device), names=[n.name for n in full.nodes[1:]])  # the receivers first
    with full:
        run_cluster.launch(full, str(device), names=[full.nodes[0].name])
        stats, sync_s = run_cluster.startup_sync(full.nodes[0])[-1]
        if stats["shardsMoved"] != len(to_move):
            raise AssertionError(f"A's startup sync moved {stats}, expected {len(to_move)} shards: {owners}")
        for name in names:
            where = _shards_by_node(full, name, shards[name])
            for sid in shards[name]:
                want = next(n.name for n in full.nodes if n.rpc == owners[sid])
                if where.get(sid) != [want]:
                    raise AssertionError(f"shard {sid} of {name} lies in {where.get(sid)}, its owner is {want}")
        for n in full.nodes:
            for name in names:
                qs, want = before[name]
                got = _vector_answers(n.http, name, "vectorIVF", qs)[0]
                if got != want:
                    raise AssertionError(f"{name} through {n.name} after the move: {got[:2]} against {want[:2]}")
        launches = _stop_cluster(full)
    log(f"[cluster] sync: {a.name} alone filled {len(names)} vectorIVF collection(s) of {CLUSTER_POINTS} points; "
        f"restarted as three nodes, its startup sync moved {stats} in {sync_s:.3f} s (its log's clock: RPC "
        f"serving to the sync's end); {len(to_move)} shard file(s) now lie at their rendezvous owners and every "
        f"node answers {CLUSTER_QUERIES} searches a collection as {a.name} did before the move; launches alone "
        f"{launches_solo}, after {launches['total']}")
    return {"collections": len(names), "shards_moved": stats["shardsMoved"],
            "collections_moved": stats["collectionsMoved"], "sync_s": sync_s,
            "launches": {k: launches_solo[k] + launches["total"][k] for k in launches_solo}}


def _cluster_budget(torch, counted, device, node_root: str, seed: int) -> dict:
    """Phase 23.5: a ShardManager on the card in this process over one node's
    BQ shard directories, its device-memory budget about half of their
    indices' bytes; every shard searched twice, round robin: the budget must
    evict, and every shard answer as it did on a load without a budget."""
    from semadb_tpu_torch.cluster.shardmgr import ShardManager
    from semadb_tpu_torch.models import Collection, IndexSchema, SearchRequest, UserPlan
    from semadb_tpu_torch.shard.registry import index_nbytes
    from semadb_tpu_torch.tools import dbpedia_bq as bq

    col = Collection(user_id=CLUSTER_USER, id=bq.COLLECTION, index_schema=IndexSchema.from_dict(bq.SCHEMA),
                     user_plan=UserPlan())
    sids = sorted(os.listdir(os.path.join(node_root, CLUSTER_USER, bq.COLLECTION)))
    srs = [SearchRequest.from_dict(bq.search_body(q, LIMIT)) for q in bq.queries(seed + 7, CLUSTER_BUDGET_QUERIES)]

    def answers(mgr, sid):
        rows = mgr.do_with_shard(col, sid, lambda s: s.search_points_batch(srs))
        return [[(str(r.point.id), r.distance) for r in row] for row in rows]

    _zero_counts(counted)
    free = ShardManager(node_root, device)
    want = {sid: answers(free, sid) for sid in sids}
    nbytes = {sid: free.do_with_shard(col, sid, lambda s: index_nbytes(s.device_indices.get(bq.INDEX_KEY)))
              for sid in sids}
    free.unload_all()
    budget = int(sum(nbytes.values()) * CLUSTER_BUDGET_SHARE)
    mgr = ShardManager(node_root, device, max_cache_size=budget)
    try:
        t0 = time.perf_counter()
        for rnd in range(2):
            for sid in sids:
                if answers(mgr, sid) != want[sid]:
                    raise AssertionError(f"BQ shard {sid} answered otherwise in round {rnd} under the budget")
        took = time.perf_counter() - t0
        evictions = mgr.hbm_budget.evictions
    finally:
        mgr.unload_all()
    launches = {nm: mod.LAUNCHES for nm, mod in counted}
    if evictions <= 0:
        raise AssertionError(f"a budget of {budget} bytes over {nbytes} evicted nothing")
    if launches["K1"] <= 0:
        raise AssertionError(f"the budgeted searches did not launch K1: {launches}")
    log(f"[cluster] budget: {len(sids)} BQ shards of one node, indices {sorted(nbytes.values())} bytes, "
        f"maxCacheSize {budget}; two round-robin passes of {CLUSTER_BUDGET_QUERIES} searches a shard in "
        f"{took:.2f} s: {evictions} evictions, every answer equal to the unbudgeted load's; K1 launches {launches['K1']}")
    return {"shards": len(sids), "index_bytes": nbytes, "max_cache_size": budget, "evictions": evictions,
            "seconds": took, "launches": launches}


def phase_cluster(torch, counted, device, seed: int) -> dict:
    """Phase 23: the JAX system's three-node cluster (config/server{A,B,C}.yaml)
    as three node processes of the port on the card, started by
    ``semadb_tpu_torch/tools/run_cluster.py``."""
    import glob
    import shutil

    from semadb_tpu_torch.tools import run_cluster

    root = tempfile.mkdtemp(prefix="semadb_smoke_cluster_")
    try:
        t0 = time.perf_counter()
        cl = run_cluster.start(root=os.path.join(root, "cluster"), device=str(device))
        with cl:
            log(f"[cluster] three nodes up in {time.perf_counter() - t0:.1f} s: "
                f"{[(n.name, n.http, n.rpc) for n in cl.nodes]}; ports rewritten (taken): {cl.rewritten_ports}")
            ing = _cluster_ingest(torch, cl, seed)
            ans = _cluster_answers(cl, ing, seed)
            conc = _cluster_concurrent(cl, ing, seed)
            launches = _stop_cluster(cl)
        missing = [k for k in CLUSTER_KERNELS if launches["total"][k] <= 0]
        if missing:
            raise AssertionError(f"the cluster's nodes never launched {missing}: {launches['by_node']}")
        log(f"[cluster] kernel launches by node (their logs at shutdown): {launches['by_node']}")
        sync = _cluster_sync(run_cluster, os.path.join(root, "sync"), device, seed)
        most = max(cl.nodes, key=lambda n: len(ing["per_node"][n.name]))
        budget = _cluster_budget(torch, counted, device, most.root, seed)
    except BaseException:
        for path in sorted(glob.glob(os.path.join(root, "*", "*.log"))):  # the nodes' logs, to place the failure
            with open(path, errors="replace") as f:
                log(f"[cluster] the end of {path}:\n" + "".join(f.readlines()[-30:]))
        raise
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: launches["total"][k] + sync["launches"][k] + budget["launches"][k] for k in launches["total"]}
    return {"ingest_points_per_s": ing["ingest_points_per_s"], "shards_by_node": ing["per_node"],
            "device_memory": ing["memory"], "p50_ms": ans["p50_ms"], "recall": ans["recall"], "concurrent": conc,
            "sync": {k: v for k, v in sync.items() if k != "launches"},
            "budget": {k: v for k, v in budget.items() if k not in ("launches", "index_bytes")},
            "launches": total, "launches_by_node": launches["by_node"],
            "rewritten_ports": cl.rewritten_ports}


BENCH_N = 1_000_000  # the bench modes' corpus, bench.py's default
BENCH_DIM = 128
BENCH_HTTP_N = 100_000  # a depth cut: HTTP ingest over loopback is host-bound
BENCH_QUERIES = 32768
BENCH_WRITE_TXNS = 100  # bench.py's write default
BENCH_SHARDWRITE_TXNS = 64  # bench.py's shardwrite default, after one warmup txn
BENCH_TXN_POINTS = 1000
SHARDWRITE_PARITY = 0.95  # top-10 overlap of the 64 probes across the crash reopen (bench.py:1118-1124)
BENCH_WRITE_RECALL = 0.99  # the IVF cell's own bar
BENCH_FILTERED_RECALL = 0.999  # both regimes are exact: only ties can cost recall
BENCH_HYBRID_RECALL = 0.97  # the JAX package read 0.9827-0.9834 (TPU history, BENCHMARKS.md:490, 680)
BENCH_HTTP_RECALL = 0.95  # phase 8b's bar
BENCH_HTTP_RTOL = 1e-5
PROJ_ARGV = ("--dim", "1536")  # BENCH_DIM=1536: the projected traversal, data made on the card
PROJ_RECALL = 0.99  # the JAX package read 0.9999 here (TPU history, BENCHMARKS.md:678)
BENCH_UNFILTERED = ("shardwrite", "write", "hybrid", "http", "projected")  # the modes whose searches run K3 and K4


def _bench_mode(counted, name: str, fn, *args, **kwargs) -> tuple:
    """One bench mode with every launch count zeroed first: (its JSON line,
    the launches it made)."""
    _zero_counts(counted)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    launches = {nm: mod.LAUNCHES for nm, mod in counted}
    log(f"[bench {name}] {time.perf_counter() - t0:.1f} s: {json.dumps(out, default=float)}; launches {launches}")
    return out, launches


def phase_bench(torch, counted, ivf_scan, ivf_rerank, device, prebuilt=None) -> dict:
    """The port's ``bench`` modes on the card at ``bench.py``'s defaults (the
    HTTP corpus cut to 100,000), each with its bar; ``prebuilt`` is phase
    8's index and queries (the same corpus as ``filtered``'s), else
    ``filtered`` builds its own."""
    from semadb_tpu_torch import bench

    t_phase = time.perf_counter()
    out, launches, errs = {}, {}, {}
    out["shardwrite"], launches["shardwrite"] = _bench_mode(
        counted, "shardwrite", bench.run_shardwrite, BENCH_N, BENCH_DIM, device, txns=BENCH_SHARDWRITE_TXNS,
        txn_points=BENCH_TXN_POINTS)
    sw = out["shardwrite"]
    if sw["journal_txns_replayed"] != BENCH_SHARDWRITE_TXNS + 1:
        raise AssertionError(f"the crash reopen replayed {sw['journal_txns_replayed']} journaled txns, not "
                             f"{BENCH_SHARDWRITE_TXNS + 1}")
    if sw["acknowledged_found"] != sw["acknowledged"]:
        raise AssertionError(f"after the crash reopen {sw['acknowledged_found']} of {sw['acknowledged']} "
                             f"acknowledged points find themselves")
    if sw["reopen_probe_parity"] < SHARDWRITE_PARITY:
        raise AssertionError(f"crash reopen probe parity {sw['reopen_probe_parity']} is below {SHARDWRITE_PARITY}")
    out["filtered"], launches["filtered"] = _bench_mode(
        counted, "filtered", bench.run_filtered, BENCH_N, BENCH_DIM, BENCH_QUERIES, device, prebuilt=prebuilt)
    for row in out["filtered"]["by_selectivity"].values():
        if row["recall@10"] < BENCH_FILTERED_RECALL:
            raise AssertionError(f"filtered recall@10 {row} is below {BENCH_FILTERED_RECALL}")
    out["write"], launches["write"] = _bench_mode(
        counted, "write", bench.run_write, BENCH_N, BENCH_DIM, BENCH_QUERIES, device, txns=BENCH_WRITE_TXNS,
        txn_points=BENCH_TXN_POINTS)
    if out["write"]["recall@10_after_writes"] < BENCH_WRITE_RECALL:
        raise AssertionError(f"recall@10 after the writes {out['write']['recall@10_after_writes']} is below "
                             f"{BENCH_WRITE_RECALL}")
    keep: dict = {}
    out["hybrid"], launches["hybrid"] = _bench_mode(counted, "hybrid", bench.run_hybrid, BENCH_N, BENCH_DIM,
                                                    BENCH_QUERIES, device, keep=keep)
    if out["hybrid"]["recall@10"] < BENCH_HYBRID_RECALL:
        raise AssertionError(f"hybrid recall@10 {out['hybrid']['recall@10']} is below {BENCH_HYBRID_RECALL}")
    for view, (idx, q) in enumerate(zip(keep["indices"], keep["views"])):
        checked = _check_path_kernels(torch, ivf_scan, ivf_rerank, idx, q[:4096], out["hybrid"]["pool"],
                                      out["hybrid"]["probes"], f"the hybrid mode's view {view + 1}")
        errs[f"hybrid_view{view + 1}"] = {key: checked[key] for key in ("k3_err", "k4_err", "shape")}
    del keep, idx, checked
    torch.cuda.empty_cache()
    out["http"], launches["http"] = _bench_mode(counted, "http", bench.run_http, BENCH_HTTP_N, BENCH_DIM,
                                                BENCH_QUERIES, device)
    if out["http"]["recall@10"] < BENCH_HTTP_RECALL or out["http"]["max_distance_rel_err"] > BENCH_HTTP_RTOL:
        raise AssertionError(f"HTTP recall@10 {out['http']['recall@10']} (bar {BENCH_HTTP_RECALL}) or distance "
                             f"error {out['http']['max_distance_rel_err']} (bar {BENCH_HTTP_RTOL})")
    res, prof, launches["projected"], _, keep = _run_annbench(counted, PROJ_ARGV, "bench projected")
    out["projected"] = res
    if res["recall@10"] < PROJ_RECALL:
        raise AssertionError(f"recall@10 at 1M x 1536 {res['recall@10']} is below {PROJ_RECALL}")
    idx, test = keep["index"], keep["queries"]
    if idx._proj is None:
        raise AssertionError("the 1536-d index does not traverse a projection")
    kc = _cell_kernels(torch, ivf_scan, ivf_rerank, idx, test[: res["batch"]], "the 1536-d cell")
    t4 = _k4_times(torch, ivf_rerank, kc["k4_ops"])
    k4_ops = kc["k4_ops"]
    one_bytes, _ = _k4_bytes(torch, idx.vectors, k4_ops[1][:1], k4_ops[2][:1], k4_ops[3][:1], k4_ops[4])
    proj = {
        "shape": {key: kc[key] for key in ("B", "p", "S", "r", "rr", "k")} | {"D": int(idx.vectors.shape[1]),
                                                                               "slab_dtype": str(idx.slabs.dtype)},
        "k3": {"ms": kc["t3"]["ms"], "plain_ms": kc["t3_plain"], "bound_ms": _bound_ms(kc["k3_bytes"]["distinct"]),
               "bytes": kc["k3_bytes"]["distinct"], "call_ms": kc["k3_call"], "max_abs_err": kc["err3"],
               "launches": launches["projected"]["K3"], "measured_by": kc["t3"]["measured_by"]},
        "k4": {"ms": t4["ms"], "b1_ms": t4["b1_ms"], "b1_call_ms": t4["b1_call_ms"], "b1_bound_ms": _bound_ms(one_bytes),
               "plain_ms": kc["t4_plain"],
               "bound_ms": _bound_ms(kc["k4_bytes"]), "bytes": kc["k4_bytes"], "distinct_rows": kc["rows4"],
               "max_abs_err": kc["err4"], "launches": launches["projected"]["K4"]},
        "profile": prof,
    }
    log(f"[bench projected] K3 {proj['k3']['ms']:.4f} ms a call (bound {proj['k3']['bound_ms']:.4f} ms, plain "
        f"{proj['k3']['plain_ms']:.4f}); K4 {t4['ms']:.4f} ms (bound {proj['k4']['bound_ms']:.4f} ms, plain "
        f"{proj['k4']['plain_ms']:.4f}) at {proj['shape']}")
    del keep, idx, test, kc
    torch.cuda.empty_cache()
    for name in BENCH_UNFILTERED:
        if launches[name]["K3"] <= 0 or launches[name]["K4"] <= 0:
            raise AssertionError(f"the {name} mode did not run K3 and K4 on the card: {launches[name]}")
    seconds = time.perf_counter() - t_phase
    log(f"[bench] every mode passed in {seconds:.1f} s; launches by mode {json.dumps(launches)}")
    return {"modes": out, "launches": launches, "checks": errs, "projected": proj, "seconds": seconds}


def _phase(name: str, fn, *args, **kwargs):
    """Run one phase between a line that says it starts and one that says it
    passed, so that a failure can be placed."""
    log(f"[phase {name}] start")
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase {name}] passed in {time.perf_counter() - t0:.1f} s")
    return out


def _k5_routes(counted, before=None) -> dict:
    """K5's calls on the card by route since the last :func:`_zero_counts`
    (or since ``before``, an earlier copy of its ``LAUNCHES_BY``): "kernel"
    and "library" (p above its cap, the torch calls), with "_b1" for B = 1."""
    by = dict(counted)["K5"].LAUNCHES_BY
    before = before or {}
    return {f"{route}{'_b1' if one else ''}": n - before.get((route, one), 0)
            for (route, one), n in sorted(by.items()) if n != before.get((route, one), 0)}


def _zero_counts(counted) -> None:
    """Every kernel's launch count to 0, before a path is driven."""
    for _, mod in counted:
        mod.LAUNCHES = 0
    for _, mod in counted:
        if hasattr(mod, "LAUNCHES_BY"):
            mod.LAUNCHES_BY.clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--k4-baseline", metavar="SOURCE",
                        help="another K4 source (ivf_rerank.cu, its ivf_common.cuh beside it), e.g. the parent "
                             "commit's, timed beside the tree's K4 in phases 8 and 8c")
    parser.add_argument("--vamana-baseline", metavar="DIR",
                        help="a directory holding another vamana_search.cu, vamana_prune.cu and vamana_common.cuh "
                             "(e.g. the parent commit's semadb_tpu_torch/csrc), checked and timed beside the tree's "
                             "K10 and K11 in phase 15")
    parser.add_argument("--k9-baseline", metavar="SOURCE",
                        help="another K9 source (ivf_pq_scan.cu, with any ivf_common.cuh beside it), e.g. the "
                             "parent commit's, checked and timed beside the tree's K9 in phase 11")
    parser.add_argument("--mesh-only", action="store_true",
                        help="run the environment, the build and phase 22 only (prints its numbers, not the kernels "
                             "line)")
    parser.add_argument("--cluster-only", action="store_true",
                        help="run the environment, the build and phase 23 only (prints its numbers, not the kernels "
                             "line)")
    parser.add_argument("--bench-only", action="store_true",
                        help="run the environment, the build and phase 24 only (prints its numbers, not the kernels "
                             "line)")
    parser.add_argument("--mesh-cards", type=int, default=0, metavar="N",
                        help="phase 22 across the first N cards (N >= 2): the fleet's 8 slots over every card in "
                             "turn, the node's mesh one slot a card; by default every slot is on one card")
    args = parser.parse_args()

    sys.modules["jax"] = None  # this script and the port never import jax
    sys.modules["semadb_tpu"] = None  # nor the JAX package
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    import semadb_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    env = _phase("1 environment", phase_environment, torch)
    hamming, gather, ivf_scan, ivf_rerank, ivf_probe_topk, ivf_pq_scan, vamana_search, vamana_prune = _phase(
        "1 build", phase_build)
    counted = (("K1", hamming), ("K2", gather), ("K3", ivf_scan), ("K4", ivf_rerank), ("K5", ivf_probe_topk),
               ("K9", ivf_pq_scan), ("K10", vamana_search), ("K11", vamana_prune))
    if args.mesh_only:
        mfleet, mhttp = run_phase_22(torch, counted, device, args)
        print(env["smi"])
        print(json.dumps({"mesh_fleet": mfleet, "mesh_http": mhttp}, default=float))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    if args.bench_only:
        bench = _phase("24 the bench workloads", phase_bench, torch, counted, ivf_scan, ivf_rerank, device)
        print(env["smi"])
        print(json.dumps({"bench": bench}, default=float))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    if args.cluster_only:
        cluster = _phase("23 the three-node cluster", phase_cluster, torch, counted, device, args.seed)
        print(env["smi"])
        print(json.dumps({"cluster": cluster}, default=float))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    worst = _phase("2 K1 against its plain version", phase_kernel, torch, hamming, device)
    sl = _phase("3 the BQ slice over HTTP", phase_slice, torch, hamming, gather, device, args.seed)
    timing = _phase("4 K1 timing", phase_timing, torch, hamming, sl["codes"], sl["qcodes"])
    by_b = timing["by_b"]
    t64 = by_b[64]
    g_worst = _phase("5 K2 against its plain version", phase_gather_kernel, torch, gather, device)
    gb = _phase("6 gatherbench", phase_gatherbench, torch, hamming, gather)
    kerr = _phase("7 K3 and K4 against their plain versions", phase_ivf_kernels, torch, ivf_scan, ivf_rerank, device)
    k5 = _phase("7 K5 against float64, timed", phase_probe_topk, torch, ivf_probe_topk, device)
    pqerr = _phase("7 K9 against its plain version", phase_pq_kernels, torch, ivf_pq_scan, device)
    baseline = load_k4_baseline(args.k4_baseline) if args.k4_baseline else None
    k9_baseline = load_k9_baseline(args.k9_baseline) if args.k9_baseline else None
    vamana_baseline = load_vamana_baseline(args.vamana_baseline) if args.vamana_baseline else None
    cell = _phase("8 the IVF cell", phase_ivf_cell, torch, counted, baseline=baseline)
    proj = _phase("8 K4 at the projected shape", phase_k4_projected, torch, ivf_rerank, args.seed, baseline)
    ihttp = _phase("8b vectorIVF over HTTP", phase_ivf_http, torch, counted, device, args.seed)
    hybrid = _phase("9 the hybrid collection over HTTP", phase_hybrid, torch, counted, device, args.seed)
    wide = _phase("9 the widened-probe filter", phase_wide_filter, torch, counted, cell["index"], cell["queries"],
                  args.seed)
    # Phase 24 runs here: its filtered mode searches phase 8's index (the same corpus)
    bench = _phase("24 the bench workloads", phase_bench, torch, counted, ivf_scan, ivf_rerank, device,
                   (cell["index"], cell["queries"]))
    del cell["index"], cell["queries"]
    big = _phase("10 the 10M cell", phase_ivf_10m, torch, counted)
    pqcell = _phase("11 the IVF-PQ cell", phase_ivfpq_cell, torch, counted, ivf_pq_scan, ivf_rerank, k9_baseline)
    fcell = _phase("12 the fused cell", phase_fused_cell, torch, counted, ivf_scan, ivf_rerank)
    http = _phase("13 PQ and fused over HTTP", phase_pq_fused_http, torch, counted, device, args.seed)
    vker = _phase("14 K10 and K11 against their plain versions", phase_vamana_kernels, torch, vamana_search,
                  vamana_prune, device)
    vcell = _phase("15 the Vamana cell", phase_vamana_cell, torch, counted, vamana_search, vamana_prune,
                   vamana_baseline)
    vhttp = _phase("16 v1 and v2 Vamana collections over HTTP", phase_vamana_http, torch, counted, device, args.seed)
    vcodes = _phase("17 K10's bit and ADC routes against their plain versions", phase_vamana_code_kernels, torch,
                    vamana_search, device)
    bqv = _phase("18 the BQ Vamana cell", phase_vamana_quant_cell, torch, counted, vamana_search, ivf_rerank, "bq")
    pqv = _phase("19 the PQ Vamana cell", phase_vamana_quant_cell, torch, counted, vamana_search, ivf_rerank, "pq")
    pool = _phase("20 the pool build", phase_vamana_pool_cell, torch, counted)
    qhttp = _phase("21 quantized vectorVamana collections over HTTP", phase_vamana_quant_http, torch, counted, device,
                   args.seed)
    log(f"[profiler] times reported by CUDA events after every window lost its kernels (P2): "
        f"{len(EVENT_FALLBACKS)} {EVENT_FALLBACKS}")
    mfleet, mhttp = run_phase_22(torch, counted, device, args)
    cluster = _phase("23 the three-node cluster", phase_cluster, torch, counted, device, args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    ivf_shape = (f"the IVF bench cell's operands: B={cell['res']['batch']} queries, p={cell['res']['probes']}, "
                 f"C={cell['res']['clusters']}, S={cell['res']['slab']}, {cell['res']['slab_dtype']} slabs; "
                 f"device time per call, mean of {IVF_TIMED_RUNS}")
    print(env["smi"])
    print(json.dumps({"kernels": [{
        "name": "K1 pairwise_bit_distance (hamming/jaccard over packed codes)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/hamming.cu",
        "replaces": "semadb_tpu/ops/pallas/hamming.py:79",
        "launches": sl["launches"],
        "launches_b1": sl["split"]["b1"],
        "launches_b_gt1": sl["split"]["b_gt1"],
        "launches_by_route": sl["routes"],
        "max_abs_err": max(worst, *(r["max_abs_err"] for r in by_b.values())),
        "ms": t64["ms"],
        "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": (f"hamming B=64 N={t64['n']} W={t64['w']} on the {t64['route']} route; device time "
                  "per call, L2-cold"),
        "call_ms": t64["call_ms"],
        "plain_call_ms": t64["plain_call_ms"],
        "by_b": {str(b): {k: r[k] for k in (
            "route", "ms", "bound_ms", "share", "int8_ops_ms", *hamming.ROUTES, "plain_ms", "call_ms")
            if k in r} for b, r in by_b.items()},
        "threshold_sweep_cold_ms": {str(b): v for b, v in timing["threshold_sweep"].items()},
        "launches_cluster": cluster["launches"]["K1"],
    }, {
        "name": "K2 gather_rows (row gather vectors[ids])",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/gather.cu",
        "replaces": "semadb_tpu/ops/pallas/gather.py:71",
        "launches": gb["launches"],
        "max_abs_err": g_worst,
        "ms": gb["ms"]["kernel"],
        "plain_ms": gb["ms"]["plain"],
        "bound_ms": gb["bound_ms"],
        "bound_by": gb["bound_by"],
        "library_ms": gb["ms"]["torch"],
        "shape": "gatherbench defaults: f32[1000000, 128] x i32[1048576]; median of 21 calls, CUDA events",
    }, {
        "name": "K3 ivf_probe_scan (probed-slab scan with a running top-rr)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "semadb_tpu/index/ivf.py:428",
        **{key: cell["k3"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(kerr["k3_err"], cell["k3"]["max_abs_err"], big["k3"]["max_abs_err"],
                           fcell["k3"]["max_abs_err"], bench["projected"]["k3"]["max_abs_err"],
                           *(c["k3_err"] for c in bench["checks"].values())),
        "library_ms": None,
        "library": LIBRARY_NONE,
        "kernels_per_call": cell["k3"]["kernels_per_call"],
        "by_kernel_ms": cell["k3"]["by_kernel_ms"],
        "b_sweep_ms": {str(b): v for b, v in cell["k3"]["b_sweep_ms"].items()},
        **{key: cell["k3"][key] for key in ("b1_call_ms", "call_ms", "event_ms", "share", "measured_by")},
        "bound_bytes": cell["k3"]["bytes"],
        "per_query_bound_ms": cell["k3"]["per_query_bound_ms"],
        "launches_hybrid": hybrid["launches"]["K3"],
        "launches_mesh": {"fleet": mfleet["launches"]["K3"], "http": mhttp["launches"]["K3"]},
        "launches_cluster": cluster["launches"]["K3"],
        "launches_wide_filter": wide["launches"]["K3"],
        "launches_bench": {mode: n["K3"] for mode, n in bench["launches"].items()},
        "projected_cell": {"shape": bench["projected"]["shape"], **bench["projected"]["k3"]},
        "shape": ivf_shape + "; every device event of a call (kernels and memset)",
        "cell_10m": {key: v for key, v in big["k3"].items() if key != "max_abs_err"},
        "fused_cell": {key: v for key, v in fcell["k3"].items() if key != "max_abs_err"},
    }, {
        "name": "K4 ivf_exact_rerank (copy dedup and exact rerank of the coarse pool)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "semadb_tpu/index/ivf.py:510",
        **{key: cell["k4"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(kerr["k4_err"], cell["k4"]["max_abs_err"], proj["max_abs_err"], big["k4"]["max_abs_err"],
                           pqcell["k4"]["max_abs_err"], fcell["k4"]["max_abs_err"],
                           bench["projected"]["k4"]["max_abs_err"], *(c["k4_err"] for c in bench["checks"].values())),
        "library_ms": None,
        "library": LIBRARY_NONE_K4,
        "bound_bytes": cell["k4"]["bytes"],
        "shape": ivf_shape + f", k=10, rr=64 with the copies, dedup inside: {cell['k4']['dedup']}",
        **{key: cell["k4"][key] for key in cell["k4"] if key.startswith(("b1_", "base_")) or key == "route"},
        "b_sweep_ms": {str(b): v for b, v in cell["k4"]["b_sweep_ms"].items()},
        "element_route_ms": cell["k4"]["element_route_ms"],
        "projected": {key: v for key, v in proj.items() if key != "max_abs_err"},
        "launches_hybrid": hybrid["launches"]["K4"],
        "launches_mesh": {"fleet": mfleet["launches"]["K4"], "http": mhttp["launches"]["K4"]},
        "launches_cluster": cluster["launches"]["K4"],
        "launches_wide_filter": wide["launches"]["K4"],
        "launches_bench": {mode: n["K4"] for mode, n in bench["launches"].items()},
        "projected_cell": {"shape": bench["projected"]["shape"], **bench["projected"]["k4"]},
        "cell_10m": {key: v for key, v in big["k4"].items() if key != "max_abs_err"},
        "ivfpq_cell": {key: v for key, v in pqcell["k4"].items() if key != "max_abs_err"},
        "fused_cell": {key: v for key, v in fcell["k4"].items() if key != "max_abs_err"},
    }, {
        "name": "K9 ivf_pq_probe_scan (ADC scan of the probed code slabs with a running top-rr)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_pq_scan.cu",
        "replaces": "semadb_tpu/index/ivf.py:579",
        **{key: pqcell["k9"][key] for key in ("launches", "ms", "plain_ms", "bound_ms", "bound_by")},
        "max_abs_err": max(pqerr["k9_err"], pqcell["k9"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE_K9,
        "shape": ("the IVF-PQ cell's operands: " + json.dumps(pqcell["k9"]["shape"])
                  + f"; device time per call, mean of {IVF_TIMED_RUNS}"),
        **{key: v for key, v in pqcell["k9"].items() if key in (
            "bytes", "distinct_clusters", "live_slots_distinct", "b1_ms", "b1_call_ms", "b1_bound_ms", "b1_plain_ms")
            or key.startswith("base_")},
        "launches_http": http["k9_by_entry"].get("probed", 0),
        "launches_mesh": mhttp["k9_by_entry"].get("probed", 0),
    }, {
        "name": "K9 pq_scan (dense ADC scan: flat PQ and the IVF-PQ overflow pool)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_pq_scan.cu",
        "replaces": "semadb_tpu/vectorstore/store.py:330",
        "launches": http["k9_by_entry"].get("dense", 0),
        **{key: http["dense"][key] for key in ("ms", "plain_ms", "bound_ms", "call_ms")},
        "bound_by": "bytes",
        "max_abs_err": max(pqerr["k9_dense_err"], http["dense"]["max_abs_err"], pqcell["k9_dense"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE_K9_DENSE,
        "shape": ("the HTTP phase's flat PQ index, one query: " + json.dumps(http["dense"]["shape"])
                  + f"; device time per call, mean of {IVF_TIMED_RUNS}"),
        "ivfpq_batch": {key: v for key, v in pqcell["k9_dense"].items() if key != "max_abs_err"},
    }, {
        "name": ("K10 vamana_beam_search (the whole beam-search walk; one warp a query at the query walk, a "
                 "block of 4-8 warps at the build's; 16-byte row loads, rows in flight; a merge "
                 "that sorts only the new entries that can enter)"),
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/vamana_search.cu",
        "replaces": "semadb_tpu/index/vamana/search.py:123",
        "launches": vcell["launches"]["K10"],
        **{key: vcell["k10"][key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "max_abs_err": max(vker["k10_err"], vcell["k10"]["max_abs_err"]),
        "library_ms": None,
        "library": LIBRARY_NONE_K10,
        "shape": vcell["k10"]["shape"] + f"; device time per call, mean of {VAMANA_TIMED_RUNS}",
        "bound_bytes": vcell["k10"]["bytes"],
        **{key: vcell["k10"][key] for key in ("distinct_rows_scored", "rows_scored", "distinct_nodes_expanded",
                                              "nodes_expanded")},
        "hops_per_query": vcell["k10"]["hops_per_query"],
        **{key: vcell["k10"][key] for key in ("build_shape", "pass2_shape") + (("base_ms",) if "base_ms" in
                                                                                vcell["k10"] else ())},
        "launches_by_shape": vcell["launches_by_shape"]["K10"],
        "launches_http": vhttp["launches"]["K10"],
        "launches_mesh": mhttp["k10_by_route"].get("f32", 0),
        "launches_cluster": cluster["launches"]["K10"],
        "checked_calls": vker["k10_calls"],
    }, {
        "name": ("K11 vamana_robust_prune (the greedy alpha prune; a block a node, the live rows staged, panels "
                 "of 32 live candidates against the later ones by a register-tiled FFMA product, a one-warp greedy "
                 "over kill masks)"),
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/vamana_prune.cu",
        "replaces": "semadb_tpu/index/vamana/build.py:97",
        "launches": vcell["launches"]["K11"],
        **{key: vcell["k11"][key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "max_abs_err": max(vker["k11_unequal"], *(1.0 - t["rows_equal"] for t in (
            vcell["k11"], vcell["k11"]["build_shape"], vcell["k11"]["overflow_shape"]))),
        "max_abs_err_is": "K11's outputs are ids: the largest share of adjacency rows unequal to the plain "
                          "version's in any check of this run (integer pools must have none)",
        "library_ms": None,
        "library": LIBRARY_NONE_K11,
        "shape": vcell["k11"]["shape"] + f"; device time per call, mean of {VAMANA_TIMED_RUNS}",
        "bound_bytes": vcell["k11"]["bytes"],
        **{key: vcell["k11"][key] for key in ("distinct_rows", "live_rows")},
        "rows_equal_real": vcell["k11"]["rows_equal"],
        **{key: vcell["k11"][key] for key in ("build_shape", "overflow_shape") + (("base_ms",) if "base_ms" in
                                                                                    vcell["k11"] else ())},
        "launches_by_shape": vcell["launches_by_shape"]["K11"],
        "launches_http": vhttp["launches"]["K11"],
        "launches_pool_cell": pool["launches"]["K11"],
        "launches_cluster": cluster["launches"]["K11"],
        "checked_calls": vker["k11_calls"],
    }, *(_k10_route_row(cell, qhttp, vcodes) for cell in (bqv, pqv)), {
        "name": "K4 ivf_exact_rerank at the quantized Vamana walk's f32 rerank (the list and the ring, dedup)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_rerank.cu",
        "replaces": "semadb_tpu/index/vamana/search.py:270",
        "launches": bqv["launches"]["K4"],
        **{key: bqv["k4"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": None,
        "library": LIBRARY_NONE_K4,
        "shape": bqv["k4"]["shape"] + f"; device time per call, mean of {IVF_TIMED_RUNS}",
        "bound_bytes": bqv["k4"]["bytes"],
        "distinct_rows": bqv["k4"]["distinct_rows"],
        "pq_cell": {key: v for key, v in pqv["k4"].items()},
        "launches_pq_cell": pqv["launches"]["K4"],
        "launches_http": qhttp["launches"]["K4"],
    }, {
        "name": "K5 ivf_probe_topk (IVF probe selection: the score tile and the top-p in one pass)",
        "route": "cuda",
        "source": "semadb_tpu_torch/csrc/ivf_probe_topk.cu",
        "replaces": "semadb_tpu/index/ivf.py:340",
        "launches": cell["k5"]["launches"],
        "launches_by_route": cell["k5"]["by_route"],
        "bound_by": "operations",
        "by_shape": k5,
        "launches_http": {"launches": ihttp["launches"]["K5"], "by_route": ihttp["k5_by_route"]},
        "launches_hybrid": hybrid["launches"]["K5"],
        "launches_wide_filter": {"launches": wide["launches"]["K5"], "by_route": wide["k5_by_route"]},
        "launches_bench": {mode: n["K5"] for mode, n in bench["launches"].items()},
        "launches_mesh": {"fleet": mfleet["launches"]["K5"], "http": mhttp["launches"]["K5"]},
        "launches_cluster": cluster["launches"]["K5"],
        "cell_10m": big["k5"],
        "ivfpq_cell": pqcell["k5"],
        "library": "the torch chain K5 replaced (GEMM, scale and shift, topk): its plain version, plain_ms",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
