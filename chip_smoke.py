#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddlerec_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --only k1 [--against OTHER_gather_pool.cu ...]
    python3 chip_smoke.py --only k1b [--against OTHER_gather_pool_bwd.cu ...]
    python3 chip_smoke.py --only 29-32 | 33-36 | 37-41 | 42-45 | 46-48 | 49-51

Phases, in order; any failure is fatal and the script exits non-zero
without a result line.  ``--only k1`` runs phases 1 and 2, K1's checks of
phase 3, and then K1 alone, checked against its plain version and timed at
every shape of phases 7, 15, 18, 22, 25, 28 and 32 and at an output of more
than 2^31 elements (``k1_only``; a minute or two).  ``--only k1b`` does the
same for K1b: phases 1 and 2, K1b's checks of phase 3, then K1b checked
against its plain version and timed at every shape of phases 7, 10, 15, 18,
22, 25, 28 and 32 and at ffm's rows under ids of every residue mod 4
(``k1b_only``).  Each ``--against`` source (another ``csrc/gather_pool.cu``,
or ``csrc/gather_pool_bwd.cu``, with the same C interface, a parent commit's
say) is built beside it and timed in turns with it at every shape.
``--only 29-32`` runs phases 1, 2 and 29-32 (a few minutes), ``--only
33-36`` phases 1, 2 and 33-36, ``--only 37-41`` phases 1, 2 and 37-41,
``--only 42-45`` phases 1, 2 and 42-45, ``--only 46-48`` phases 1, 2 and 46-48,
``--only 49-51`` phases 1, 2 and 49-51.

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel of ``paddlerec_tpu_torch/csrc`` with ``nvcc``;
3. kernels K1 (``gather_pool``) and K1b (``gather_pool_bwd``, its gradient)
   against their plain PyTorch versions on the card, on every case below,
   with the tolerance stated beside it, and ``backward()`` through the
   ``autograd.Function`` against autograd through the plain version;
4. the serving path at the full width of ``configs/rank/deepfm/config.yaml``
   (vocab 1,000,001, 26 slots, tower [512, 256, 128, 32]): export a seeded
   artifact, write Criteo slot text, ``run_predict`` on the card at batch
   512 and 8192, and hold the predictions against the port's own CPU run of
   the same artifact and rows (atol 1e-5);
5. serve: ``RecService`` on 127.0.0.1, three ``RecClient`` requests whose
   answers must match ``run_predict`` for the same rows (atol 1e-5);
6. the training path at the same width, Adam: the first 5 steps against the
   port's own CPU run from the same parameters and batches (loss atol
   1e-5); ``Trainer.train()`` over slotbin files through the staged
   superbatch feed with ``wire_format: compact`` at batch 8192 (24 steps)
   and 512 (96 steps), one epoch each, one K1 and one K1b launch per step,
   the loss finite and falling; ``Trainer.evaluate()`` from the saved
   checkpoint; a short run with the bfloat16 table;
7. time K1 and K1b at the main path's shapes with CUDA events, beside their
   plain versions, the one-call PyTorch yardsticks (``embedding_bag``,
   ``embedding_dense_backward``, which the port never calls), the memory
   bound and the launch floor (an empty kernel); K1 through
   ``time_k1_shapes`` and K1b through ``time_k1b_shapes``, which every
   phase that times the kernel calls, each shape first checked against the
   plain version (``MAIN_SHAPES``: DeepFM's view at both batches, ffm's and
   lr's rows, ``config_bigdata.yaml``'s bf16 view read into float32;
   ``K1B_MAIN_SHAPES``: their gradients, DeepFM's bf16 table's among them,
   K1b also beside ``index_add_`` into zeros);
8. ``torch.profiler`` over 20 forwards and over 20 train steps at each
   batch size;
9. the sparse row-wise path: each update rule on the card against the port's
   CPU run of the same inputs, ``stochastic_round_bf16`` bitwise given the
   noise, the first 5 sparse steps card against CPU at vocab 1,000,001;
   then ``configs/rank/deepfm/config_bigdata.yaml`` at its full width (vocab
   100,000,001, a 3.2 GB bfloat16 table, row-wise adagrad with stochastic
   rounding, batch 8192): the external lookup and the per-row gradient sum
   through K1 and K1b against their plain versions, two epochs of 24 steps
   of ``Trainer.train()`` through the staged feed, ``evaluate()``, the
   checkpoint, ``tools.export`` and ``run_predict`` on the artifact, with
   the peak allocation held under table + row state + 1 GB; 8 steps each of
   the dnn and wide_deep ``config_bigdata.yaml``;
10. the sparse step profiled as in 8 (vocab 1,000,001, beside the dense
    step's numbers), the host and device dedup timed, and K1b timed at its
    compact shape;
11. the CTR rank zoo (lr, logistic_regression, fm, slot_dnn, dcn, dcn_v2, dlrm,
    xdeepfm, autoint, gatenet, flen, deepfefm, difm, ffm, fat_deepffm, fgcnn,
    autofis): each model's ``configs/rank/<model>/config.yaml`` at full
    width, a module on the card and its twin on the CPU from one seed (the
    first that gives the parameters a gradient: dlrm's head can start dead),
    one forward and three train steps at batch 512, predictions and losses card
    against CPU, with the K1 and K1b launches per forward and step asserted
    (one per table: two for ffm);
12. dcn_v2, xdeepfm, dlrm and ffm at full width through the entry points:
    ``export_model`` and ``run_predict`` at batch 8192 (card against the
    port's CPU run, atol 1e-5), ``Trainer.train()`` for two epochs of 24
    steps at batch 8192 and ``evaluate()``, with the peak allocation and the
    launches by row width; dlrm beside the same run on the CPU (its loss may
    stay at log 2 only if the twin's head died too); dcn_v2 also with
    ``sparse_update: true`` (bfloat16 table, row-wise adagrad);
    ``torch.profiler`` over the dcn_v2 and xdeepfm train step;
13. the behaviour-sequence models (din, dien, bst, dsin, dmr, dpin): each
    model's ``configs/rank/<model>/config.yaml`` at full width, a module on the
    card and its twin on the CPU from one seed, one forward and three train
    steps at the config's batch 32, predictions and losses card against CPU
    (atol 1e-5), one K1 launch per ``Embed`` table and forward and one K1b per
    table and step, asserted by row width;
14. din and dien through the entry points on rows in ``DINDataset``'s format
    written from ``--seed`` (a planted signal): ``Trainer.train()`` for two
    epochs of 100 steps at batch 32, the loss falling, ``evaluate()`` from the
    checkpoint, ``export_model`` and ``run_predict`` at batch 32 and 1024 card
    against CPU (atol 1e-5), ``torch.profiler`` over one train step each; dmr
    through ``tools.train`` on rows in its own format;
15. K1 and K1b timed at the sequence models' shapes (fill mode);
16. the rest of the rank family (deeprec, iprec, naml, fastformer, sign,
    bert4rec): each model's ``configs/rank/<model>/config.yaml`` at full width,
    card against a CPU twin from one seed as in 13 (sign's gates from the same
    noise; bert4rec compared on its logits), one K1 launch per ``Embed`` table
    and forward and one K1b per table and step (deeprec 0, iprec 3, naml 3,
    fastformer 5, sign 2, bert4rec 3);
17. naml (planted signal) and bert4rec (Markov-chain sequences) through
    ``Trainer.train()`` for two epochs of 60 steps and ``evaluate()``
    (AUC above 0.5; accuracy above five times chance), the loss falling;
    deeprec, iprec, fastformer and sign through ``tools.train`` for two
    epochs of 60 steps; iprec, naml and fastformer exported and served by
    ``run_predict`` at batch 32 and 1024 card against CPU (atol 1e-5);
    ``torch.profiler`` over the iprec and fastformer train step;
18. K1 and K1b at their new shapes (a 102-row word table under 19,200 ids,
    bert4rec's sentence table with every id 0, fastformer's 400-wide position
    rows, iprec's 554,238-row user table under 65,312 ids), each held against
    its plain version, then timed;
19. the multitask family (share_bottom, mmoe, ple, esmm, aitm, escm2,
    dselect_k, maml, metaheac): each model's ``configs/multitask/<model>/
    config.yaml`` at the ModelDef's default widths, card against a CPU twin
    from one seed, one inference forward and three train steps at batch 32
    (maml's twin at ``MT_TWIN_TASKS`` tasks; atol 1e-5; maml and metaheac on
    their meta-losses after the inner loop;
    maml's steps each from the twin's state, in float64 over one step at
    1e-5 and in float32 at 1e-3, its conditioning: see ``MT_FLOAT64``),
    K1 and K1b launches per forward and step asserted (none for the census
    models, dselect_k and maml; one and one for esmm, aitm, escm2; metaheac's
    20 tables × 5 tasks × support, query and the second order);
20. every multitask model through ``Trainer.train()`` for two epochs and
    ``evaluate()`` on rows in its reader's format with a planted signal (the
    loss falling, every AUC above 0.5, dselect_k's accuracies above 0.1,
    maml's 5-way accuracy after adaptation above 0.2); mmoe and esmm served
    at batch 32 and 1024 and metaheac at batch 32 (its inference adapts,
    with gradients on), card against CPU; ``torch.profiler`` over the esmm,
    metaheac and maml train step;
21. the second order through K1 and K1b (``autograd.grad`` of
    ``autograd.grad``, ids out of range among them) against the plain
    version at metaheac's ``dynamic_3`` shape and the Ali-CCP table's view;
22. K1 and K1b at the multitask family's shapes (the Ali-CCP view under a
    masked L = 3 pool at batch 32 and 1024, ``dynamic_3`` in fill mode, and
    K1 as K1b's backward), each held against its plain version, then timed;
    K1b also at each of metaheac's tables as its steps scatter them;
23. the match, content-understanding and recall models (match.dssm,
    match.multiview_simnet, match.match_pyramid, match.kim,
    contentunderstanding.textcnn, contentunderstanding.tagspace, recall.ncf,
    recall.word2vec): each model's ``configs/<family>/<model>/config.yaml``
    at the ModelDef's default widths, card against a CPU twin from one seed
    (tables that start at zero filled from it), one forward and three
    train steps at batch 32 (kim's at 8: ``TWIN_ROWS``; atol 1e-5), one K1
    launch per ``Embed`` table
    and forward and one K1b per table and step (dssm 0, multiview_simnet 1,
    match_pyramid 1, kim 1, textcnn 1, tagspace 2, ncf 4, word2vec 3);
24. each of them through ``Trainer.train()`` for two epochs and
    ``evaluate()`` on rows in its reader's format with a planted signal (the
    loss falling, ``pnr``/``auc`` above 0.5); match_pyramid, textcnn and
    tagspace exported and served at batch 32 and 1024 and kim at batch 32,
    card against CPU; ``cal_pos_neg`` on match_pyramid's served scores;
    word2vec's checkpoint through ``tools.analogy_eval`` on the card and on
    the CPU; ``torch.profiler`` over a kim and a tagspace step;
25. K1 and K1b at the shapes of phases 23 and 24 (``MATCH_SHAPES``: rows of
    50, 10, 300 and 128 lanes, the 4-row tag table and kim's 1,891-row word
    table under ~50,000 ids, multiview's masked bags of L = 8), each held
    against its plain version, then timed; every K1 and K1b launch of phases
    23 and 24 is at one of them;
26. recall's deepwalk, mind, tisas, ensfm and mhcn and the graph family
    (graph.gnn, graph.lightgcn, graph.transformer_conv, graph.deepwalk_million):
    each model's ``configs/<family>/<model>/config.yaml`` at the ModelDef's
    default widths (mhcn on its demo graph), card against a CPU twin from
    one seed, one forward and three train steps at batch 32 (atol 1e-5;
    mhcn's shuffles the same on both), K1 launches per forward and K1 and K1b
    per step asserted (one and one; tisas five and five; ensfm four, then
    five with its gather from q; mhcn two and two);
27. each of them through ``Trainer.train()`` for two epochs and
    ``evaluate()`` on rows in its reader's format with a planted signal (the
    loss falling, ``auc`` above 0.5 where the model has one), the graph
    models' batches from the native walk engine (``GraphChunkedDataset``;
    the run fails if ``native/graph_engine.cpp`` does not build), mhcn also
    through ``set_graph`` on a seeded graph; the serving calls (deepwalk's
    ``node_embeddings``, mind's ``user_capsules``, tisas's ``score_items``,
    ensfm's scores, mhcn's ``user_item_embeddings``) card against CPU at
    batch 32, then timed at batch 32 and 1024 (p50, p99 of 100 calls); the
    walk feeds (deepwalk's, graph.gnn's, graph.deepwalk_million's) read and
    stepped for 200 batches on a graph of BlogCatalog's size (333,983 edges
    at the configs' node counts); deepwalk,
    graph.gnn, tisas and ensfm exported and served by ``run_predict`` card
    against CPU; ``torch.profiler`` over a tisas and a mind step;
28. K1 and K1b at the shapes of phases 26 and 27 (``GRAPH_SHAPES``: tisas's
    time matrices, 257 × 50 at N = 80,000 and 2,560,000, its positions and
    items, mind's 367,983 × 64 table, the graph tables, ensfm's tables and
    its clip gather from an activation with half the ids clipped onto one
    row, mhcn's clip gathers), each held against its plain version, then
    timed; every K1 and K1b launch of phases 26 and 27 is at one of them;
29. the tree family (``tree_paths``): TDM at the widths of
    ``configs/treebased/tdm/config.yaml`` on a tree of 65,536 seeded items in
    64 categories (16 levels, 131,071 nodes), card against a CPU twin, two
    epochs of ``Trainer.train()`` and ``evaluate()``, the beam-search
    ``retrieve`` at batch 32 and 1024 (the CPU twin's item lists, the
    history's category recalled above chance, p50/p99 of 100 calls), and JTM
    through ``tools/jtm.py`` on ``configs/treebased/jtm/config.yaml`` with a
    4,096-item tree;
30. rl.a2c at the ModelDef's defaults (``a2c_phase``): a rollout's loss and
    gradients card against CPU on the same actions, then 20,000 frames of
    ``train()``, the last greedy return above the untrained policy's;
31. the movie demo (``movie_paths``) at vocab 600,000, dim 9, towers [512,
    256, 128, 32], batch 32: both models card against a CPU twin, two epochs
    of ``train_step`` each, every user's and movie's vector in a cosine
    ``VectorIndex``, the five services and ``serve_http`` answering as the
    CPU twin's (p50/p99 of 300 calls each);
32. K1 and K1b at the shapes of phases 29-31 (``SLICE_SHAPES``), each held
    against its plain version, then timed; every K1 and K1b launch of phases
    29-31 is at one of them;
33. the online day/pass loop on ``configs/rank/slot_dnn/config.yaml`` at
    full width (vocab 1,000,001, dim 9, tower [512, 256, 128, 32], Adam,
    batch 32) through ``tools/online_train.py``'s ``main`` (``online_slot_dnn``):
    one seeded day of four passes of 1,024 planted-signal rows, each pass
    directory marked ready by a data donefile; the first base, a checkpoint
    every 2 passes, a delta every pass in 2 cube shards, the day's shrink and
    base.  Each delta equal to K1's gather of its logical ids from the card's
    table at its publish and to a checkpoint of the same state (bitwise);
    the CPU port on the same day from the card's initial parameters (per-pass
    losses atol 1e-4, join-time AUCs atol 1e-3, records and every
    ``delta_meta.json`` equal); the evicted rows exactly 0 in the table and
    its moments; a second run of the day trains no pass; the day's base
    through ``tools/export_cube.py`` into 2 shards, served by two
    ``cube_server`` processes and read back with ``RemoteCubeClient`` equal
    to K1's gather from the final table (every key, and 1,024 past the
    table as zeros);
34. ``configs/rank/deepfm/config_bigdata.yaml`` online at its full
    vocabulary (``online_bigdata``: the 3.2 GB bfloat16 table, row-wise
    adagrad, batch 8192, the Python reader): one day of four passes of three
    batches over the whole vocabulary, a delta every pass and the day's base;
    each delta holds exactly the ids of the pass's touched rows, equal to
    K1's bfloat16 → float32 gather bitwise; two servers answer the last
    delta; the rows touched, the deltas' bytes against the table's, the
    ``FeatureStats`` of its 12.5 M rows and the loop's ``phase_times``;
35. din online at ``configs/rank/din/config.yaml``'s defaults
    (``online_din``): one day of two passes; every delta covers the item,
    category and item-bias tables that ``touched_tables`` names, and the
    shrink acts per table;
36. K1 at every shape of phases 33-35 (the lookups and each table's delta
    gather, ``online_k1_shapes``) and K1b at their new shapes, each held
    against its plain version, then timed; every K1 launch of phases 33-35 is
    at one of them;
37. the host-tiered table (``host_table_phase``): ``configs/rank/dnn/
    config_bigdata.yaml`` (vocab 100,000,001, dim 9: 12,500,001 physical host
    rows; bf16 cache, row-wise adagrad with stochastic rounding, batch 8192)
    through ``HostTableTrainer`` with ``use_host_table``, a 1,048,576-row
    cache (256 MB), a file a pass, superbatches and the compact wire, over
    three seeded passes of 8 batches (~415,000 physical rows a pass, ~555,000
    in all): the first 2 steps against the port's CPU run of the same pass
    given the same rounding noise (loss atol 1e-4); a RAM-only leg and a
    spill leg (``host_table_ram_rows`` 500,000: rows on disk), each one K1
    and one K1b a step, the loss finite and falling, the peak allocation
    under cache + row state + dense + 1 GB; the legs' final rows the same ids,
    values within rtol 2^-6 / atol 1e-5 (K1b's atomics order); ``save``,
    ``load`` into a fresh trainer (bitwise) and one more pass; per pass the
    seconds of ``begin_pass``, the upload, the steps, the flush and the wait
    for the next pass's preparation, the rows cached and the rows in RAM and
    on disk;
38. the device-resident feed (``resident_feed``): DeepFM at
    ``configs/rank/deepfm/config.yaml``'s width, batch 8192, superbatches,
    three epochs with ``feed_device_resident``: the train and eval corpora
    copied to the card once and replayed, the bytes held there, and the last
    epoch's examples/s beside a streaming run's (host clock, information);
39. the native feed (``native_feed``): the dnn, deepfm and wide_deep
    ``config_bigdata.yaml`` read slot text through ``NativeSlotDataset``
    with no fallback, batches bitwise the Python reader's, 8 ``train()``
    steps each; ``tools.dataset_convert`` to slotbin read back equal;
    ``pipe_command`` through the built ``criteo_parser``; the native and the
    Python parse's rows/s;
40. observability (``observability``): ``profiler_options`` writes a trace
    holding K1's kernel, ``use_visual`` a scalar line every step, and
    ``dump_fields`` from the card's ``evaluate()`` agrees with its CPU
    twin's through ``diff_report`` (max abs diff ≤ 1e-5);
41. K1 from the host table's cache view (8,388,608 × 16 bf16 into float32)
    and K1b into its compact buffer at batch 8192, each held against its
    plain version, then timed; every K1 and K1b launch of phase 37 is at one
    of them, and every one of phases 38-40 at DeepFM's view or the 10^8
    table's (phases 7 and 10 time those);
42. ``RankModel`` (``uapi``) on ``configs/rank/deepfm/config.yaml`` at full
    width (``rank_model_phase``): ``train`` for 8 steps of batch 512 on
    seeded Criteo rows, ``evaluate`` from the checkpoint, ``export``,
    ``predict`` (its ``predictions.txt`` against the same artifact's CPU run,
    2e-6: one step of ``%.6f``), ``compression`` (the artifact's bytes before
    and after; every int8 element within half a step of its row's scale)
    and ``infer`` from the compressed artifact, within 0.02 of the
    uncompressed predictions; ``load_exported`` dequantizes the table;
43. ``tools.feature_importance`` on that checkpoint over three slot groups
    of 1,024 eval rows, the baseline AUC and the deltas against the same
    tool on the CPU (atol 1e-4: a prediction 1e-7 away may change bucket);
44. TIPC (``tools.tipc``) from a temporary directory: the port's criteo
    fixture, ``run_mode`` of ``lite_train_lite_infer`` on
    ``test_tipc/configs/dnn/train_infer_python.txt`` (three "Run
    successfully" lines), then ``run_benchmark`` at batch 512 with device
    counts 1 and 2 (2 recorded as skipped: the world is one card), the
    record's backend the card;
45. the all_to_all engine through the launcher (``engine_phase``):
    ``tools.launch --nproc 1 --backend nccl`` runs this script's
    ``engine_rank``, which builds ``ShardedEmbedding`` at mp = 1 over
    DeepFM's packed table (125,001 × 128 float32) and steps it 3 times at
    8192 × 26 ids, every exchange an NCCL collective; the first step's
    forward bitwise and its gradient (rtol 1e-5) against the plain packed
    lookup, the overflow count 0, and K1 (the shard's gather) and K1b (its
    scatter) timed at the exchange's own ids beside ``index_select`` /
    ``embedding_dense_backward`` and ``index_add_`` of the valid ids, and
    the byte bound of what those ids need; then K1 and K1b
    at phase 44's shapes (dnn's table at batch 16 and 512), each held
    against its plain version and timed;
46. the trainer on a 2×2 mesh (``mesh_phase``): ``tools.launch --nproc 4
    --backend gloo`` runs this script's ``mesh_rank`` four times, every rank
    on the one card (collectives through the host): DeepFM at
    ``config.yaml``'s width through ``Trainer.train()`` at batch 512 a dp
    row, 20 steps over 4 seeded slotbin files, against the 1×1 run of the
    same global batches from the same start (``MESH_TOL``), the replicas of
    every shard and dense leaf bitwise, overflow 0, a trainer resumed from
    the epoch's checkpoint equal and taking the same next step, examples/s
    and the exchange's share of a step; then 1×4 on skewed ids in the same
    processes: the overflow count above 0 and ``overflow_raise_after``'s
    error;
47. ``config_bigdata.yaml`` (vocab 100,000,001, bf16 6,250,001-row shards,
    row-wise adagrad, stochastic rounding) on 2×2 at batch 8192 a dp row, 10
    steps of ``Trainer.train()``, against the 1×1 run (``BIG_MESH_TOL``):
    sampled touched rows and every touched accumulator, untouched rows
    bitwise unchanged, replicas equal;
48. K1 and K1b at the mesh's shapes (``time_mesh_kernels``, on the ids rank 0
    kept): the shard gathers (62,501 f32 and 6,250,001 bf16 rows), the
    engine's scatter into DeepFM's shard, the row rules' global per-unique
    merge, each held against its plain version and timed beside the library
    call and the bound of the valid ids;
49. geo across processes (``cross_phases``): ``tools.launch --nproc 2
    --backend gloo`` runs this script's ``geo_rank`` twice, both ranks on the
    card, and the same launch on the CPU: DeepFM at ``config.yaml``'s width
    with ``sync_mode: geo`` (k = 4) at batch 512 over three seeded files (6
    and 3 batches a worker) from one start: every worker trains all its
    batches, the rendezvous bytes are the touched rows' and the dense
    leaves', the ranks bitwise equal after each rendezvous, the untouched
    rows at their start, the card against the CPU run (``GEO_TOL``);
50. FL on the same ranks: 2 rounds, half the clients a round: the plan the
    same on every rank, the weights the chosen clients' examples over
    their sum, the ranks bitwise after each round, the card against the CPU;
51. slot_dnn's online day of two passes on 2×2 (4 ranks of
    ``online_cross_rank`` on the card, the table sharded over mp): the
    merged stats and evictions the same on every rank and the 1×1 run's,
    rank 0 alone writing, each delta K1's gather of the dp rows' touched
    rows from the table gathered whole, deltas and table against the 1×1
    run of the same global batches (``ONLINE51_TOL``); then K1 and K1b at
    the new shapes (geo's touched-row gather, the delta gathers and the
    engine's gather and scatter on a shard), each held against its plain
    version and timed.  Each phase prints a ``{"phase": ...}`` line as it
    ends, and one line gives every phase's seconds.

K1b's ``launches`` in the ``kernels`` line are those of each case's own
(rows, D, dtable dtype, N) over the main path (a case the main path does
not run shows 0), and ``lost_ms`` is launches × (ms − max(bound, floor)).

Phase 3 covers the shapes the zoo and the sequence models add to the main
path: rows of 8 lanes (the view of lr's and ffm's width-1 packed table), of
351 lanes (ffm's unpacked table, rows of 1,404 bytes: both kernels' scalar
path), and the ``Embed`` tables in fill mode at D = 1, 4, 32 and 64 (ids out
of range among them); phases 7 and 15 time both kernels there.

Standard output: the ``nvidia-smi`` line, one JSON line per phase's result
(each tagged with the card), the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Logs go to standard error.
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import glob
import itertools
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "rank", "deepfm", "config.yaml")
BIGDATA = os.path.join(ROOT, "configs", "rank", "{}", "config_bigdata.yaml")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SM_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: sizes the spin in time_ms
BATCHES = (512, 8192)  # serving batch; config_bigdata.yaml's infer batch
ROWS = 8192 + 1000  # a full batch of 8192 and a padded tail
TRAIN_STEPS = {8192: 24, 512: 96}  # steps of the one epoch that is trained
SLOTS = 26
GB = 1 << 30
FFM_DIM = 39 * 9  # ffm's unpacked row: one E-vector per sparse and dense field
ZOO = ("lr", "logistic_regression", "fm", "slot_dnn", "dcn", "dcn_v2", "dlrm",
       "xdeepfm", "autoint", "gatenet", "flen", "deepfefm", "difm", "ffm",
       "fat_deepffm", "fgcnn", "autofis")
ZOO_TABLES = {"ffm": 2}  # K1 launches per forward and K1b per step: one per table
ZOO_PATHS = ("dcn_v2", "xdeepfm", "dlrm", "ffm")  # served and trained at batch 8192
# dlrm's towers end in the MLP's trailing ReLU, as in the JAX package, so its
# two-unit head can die: both units at or below 0 on every row, logits 0, loss
# log 2, no gradient (tests/test_torch_zoo_train.py shows both packages reach
# that state under Adam at these tower sizes).  Its run on the card is held
# against a CPU twin's: the loss must fall unless the twin's head died too.
ZOO_HEAD_MAY_DIE = ("dlrm",)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0]


def _uncounted(fn):
    """The launches inside ``fn`` (a check against the plain version, a
    timing, a profile) stay out of ``gather_pool.launches_by_shape`` and
    ``gather_pool_bwd.launches_by_shape``, which count the launches of the
    main path."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from paddlerec_tpu_torch.ops.gather_pool import gather_pool, gather_pool_bwd

        saved = [(c, collections.Counter(c)) for c in (gather_pool.launches_by_shape,
                                                       gather_pool_bwd.launches_by_shape)]
        try:
            return fn(*args, **kwargs)
        finally:
            for counter, before in saved:
                counter.clear()
                counter.update(before)
    return wrapper


def check_k1(gp, seed: int, card: str, wide: torch.Tensor) -> float:
    """Phase 3.  ``wide`` is ffm's unpacked (1,000,001, 351) float32 table.
    Returns the largest error on the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    packed = torch.randn(125001, 128, device="cuda", generator=g)  # DeepFM's table
    view16 = packed.view(-1, 16)
    # lr's rank-1 table: 16 ids per row, read through its 8-lane view
    view8 = torch.randn(62501, 128, device="cuda", generator=g).view(-1, 8)
    wide_bf16 = wide.to(torch.bfloat16)
    n_small, n_big = 512 * SLOTS, 8192 * SLOTS  # the zoo's batch, the training batch

    def ids(n, pool, rows):
        return torch.randint(0, rows, (n, pool), device="cuda", generator=g,
                             dtype=torch.int32)

    def mask01(n, pool):
        return (torch.rand(n, pool, device="cuda", generator=g) < 0.7).float()

    # tolerance: "bitwise", "zero" (the output must be exactly 0), or
    # (rtol, atol) where sums run in another order (f32) or one f32 sum is
    # rounded once to bf16 on both sides
    cases = [
        ("f32 D16 L1 B512", view16, ids(512 * SLOTS, 1, view16.shape[0]), None, "bitwise"),
        ("f32 D16 L1 B8192", view16, ids(8192 * SLOTS, 1, view16.shape[0]), None, "bitwise"),
        ("f32 D128 L3 mask", packed, ids(4096, 3, 125001), mask01(4096, 3), (1e-5, 1e-6)),
        ("f32 D128 L8 mask", packed, ids(4096, 8, 125001), mask01(4096, 8), (1e-5, 1e-6)),
        ("f32 zero mask", packed, ids(1024, 8, 125001),
         torch.zeros(1024, 8, device="cuda"), "zero"),
        ("f32 N13313 L200", view16, ids(13313, 200, view16.shape[0]),
         mask01(13313, 200), (1e-5, 1e-4)),
        # rows of 40 bytes, and a table 4 bytes off 16-byte alignment: the
        # kernel's scalar path
        ("f32 D10 L3", packed.reshape(-1)[:10000].view(1000, 10),
         ids(999, 3, 1000), None, (1e-5, 1e-6)),
        ("f32 D16 L1 misaligned", packed.reshape(-1)[1:16001].view(1000, 16),
         ids(999, 1, 1000), None, "bitwise"),
        # the bf16 table's training and evaluation lookups
        ("bf16 D16 L1 B512", view16.to(torch.bfloat16),
         ids(512 * SLOTS, 1, view16.shape[0]), None, "bitwise"),
        ("bf16 D16 L1 B8192", view16.to(torch.bfloat16),
         ids(8192 * SLOTS, 1, view16.shape[0]), None, "bitwise"),
        ("bf16 D16 L8 mask", view16.to(torch.bfloat16), ids(8192, 8, view16.shape[0]),
         mask01(8192, 8), (1e-2, 1e-5)),
        ("bf16 D16 L8 mask →f32", view16.to(torch.bfloat16),
         ids(8192, 8, view16.shape[0]), mask01(8192, 8), (1e-6, 1e-6)),
        # the zoo's shapes: 32- and 16-byte rows (lr, ffm's first_weight), and
        # ffm's 1,404- and 702-byte rows, no multiple of 16: the scalar path
        ("f32 D8 L1 B512", view8, ids(n_small, 1, view8.shape[0]), None, "bitwise"),
        ("f32 D8 L1 B8192", view8, ids(n_big, 1, view8.shape[0]), None, "bitwise"),
        ("f32 D8 L3 mask", view8, ids(4096, 3, view8.shape[0]), mask01(4096, 3),
         (1e-5, 1e-6)),
        ("bf16 D8 L1 B8192", view8.to(torch.bfloat16), ids(n_big, 1, view8.shape[0]),
         None, "bitwise"),
        ("bf16 D8 L3 mask", view8.to(torch.bfloat16), ids(4096, 3, view8.shape[0]),
         mask01(4096, 3), (1e-2, 1e-5)),
        ("f32 D351 L1 B512", wide, ids(n_small, 1, wide.shape[0]), None, "bitwise"),
        ("f32 D351 L1 B8192", wide, ids(n_big, 1, wide.shape[0]), None, "bitwise"),
        ("f32 D351 L3 mask", wide, ids(4096, 3, wide.shape[0]), mask01(4096, 3),
         (1e-5, 1e-6)),
        ("bf16 D351 L1 B8192", wide_bf16, ids(n_big, 1, wide.shape[0]), None, "bitwise"),
        ("bf16 D351 L3 mask", wide_bf16, ids(4096, 3, wide.shape[0]), mask01(4096, 3),
         (1e-2, 1e-5)),
    ]
    # the sequence models' tables (Embed: fill mode, plain float32 tables,
    # one id per row, N = all ids of a call at batch 32): din's item table
    # (history and target, D=64) and its 4-byte item bias (D=1, the scalar
    # path), dsin's brand table (D=4, 16-byte rows), dmr's brand table
    # (D=32); each also with ids out of range (a NaN row where jnp.take
    # gives one)
    for dim, rows, n in ((64, 63001, 32 * 128 + 32), (1, 63001, 32), (4, 461499, 32 + 1600),
                         (32, 461529, 32 + 1600)):
        table = torch.randn(rows, dim, device="cuda", generator=g)
        cases.append((f"fill f32 D{dim} L1 N{n}", table, ids(n, 1, rows), None, "bitwise"))
        cases.append((f"fill f32 D{dim} L1 out of range", table,
                      ids(4096, 1, 3 * rows) - rows - 1, None, "bitwise"))
    results, main_err = [], 0.0
    for name, table, idx, mask, tol in cases:
        # "→f32": the float32 sum of bf16 rows, written unrounded
        out_dtype = torch.float32 if name.endswith("→f32") else None
        mode = "fill" if name.startswith("fill") else "clip"
        out = gp.gather_pool(table, idx, mask, out_dtype, mode=mode)
        torch.cuda.synchronize()
        ref = gp.gather_pool_plain(table, idx, mask, out_dtype, mode=mode)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).nan_to_num().abs().max())
        if mode == "fill" and not torch.equal(out.isnan(), ref.isnan()):
            ok = False
        elif tol == "bitwise":
            ok = torch.equal(out.nan_to_num(), ref.nan_to_num())
        elif tol == "zero":
            ok = float(out.abs().max()) == 0.0
        else:
            ok = torch.allclose(out.float(), ref.float(), rtol=tol[0], atol=tol[1])
        results.append({
            "case": name, "n": idx.shape[0], "pool": idx.shape[1],
            "dim": table.shape[1], "max_abs_err": err, "ok": ok,
            "tolerance": tol if isinstance(tol, str) else {"rtol": tol[0], "atol": tol[1]},
        })
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {results[-1]}")
        if name.endswith(("L1 B512", "L1 B8192")) or name.startswith("fill"):
            main_err = max(main_err, err)
        del out, ref
    emit({"k1_checks": results, "card": card})
    return main_err


def check_k1b(gp, seed: int, card: str) -> float:
    """Phase 3, K1b.  Returns the largest error on the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    view_rows = 125001 * 8  # DeepFM's table through its (R*8, 16) view

    def grad(n, dim, dtype=torch.float32):
        return torch.randn(n, dim, device="cuda", generator=g).to(dtype)

    def ids(n, pool, rows):
        return torch.randint(0, rows, (n, pool), device="cuda", generator=g,
                             dtype=torch.int32)

    def skewed(n, pool, rows):
        # Zipf-like: a tenth of the ids hit row 0, a fifth the first 64 rows
        u = torch.rand(n, pool, device="cuda", generator=g)
        return (u.pow(6) * rows).to(torch.int32)

    def mask01(n, pool):
        return (torch.rand(n, pool, device="cuda", generator=g) < 0.7).float()

    bf16 = torch.bfloat16
    n_small, n_big = 512 * SLOTS, 8192 * SLOTS
    # tolerance: "bitwise", "zero", or (rtol, atol).  Atomic float adds
    # arrive in an order of their own, so a row that takes three or more
    # adds differs from the plain version's sum in its last bits; the
    # error grows with the root of the number of adds.  A bf16 result is
    # one f32 sum rounded once on both sides (rtol 1e-2 = one bf16 ulp).
    cases = [
        ("f32 D16 L1 B512", grad(n_small, 16), ids(n_small, 1, view_rows), None,
         view_rows, None, (1e-5, 1e-6)),
        ("f32 D16 L1 B8192", grad(n_big, 16), ids(n_big, 1, view_rows), None,
         view_rows, None, (1e-5, 1e-6)),
        ("bf16 D16 L1 B512", grad(n_small, 16, bf16), ids(n_small, 1, view_rows), None,
         view_rows, None, (1e-2, 1e-6)),
        ("bf16 D16 L1 B8192", grad(n_big, 16, bf16), ids(n_big, 1, view_rows), None,
         view_rows, None, (1e-2, 1e-6)),
        ("f32 D128 L3 mask", grad(4096, 128), ids(4096, 3, 125001),
         mask01(4096, 3), 125001, None, (1e-5, 1e-6)),
        ("f32 D128 L8 mask", grad(4096, 128), ids(4096, 8, 125001),
         mask01(4096, 8), 125001, None, (1e-5, 1e-6)),
        ("f32 N13313 L200", grad(13313, 16), ids(13313, 200, view_rows),
         mask01(13313, 200), view_rows, None, (1e-5, 1e-5)),
        ("f32 D10 L3 scalar path", grad(999, 10), ids(999, 3, 1000), None,
         1000, None, (1e-5, 1e-5)),
        ("f32 D16 L1 unique ids", grad(8192, 16),
         torch.randperm(view_rows, device="cuda", generator=g)[:8192]
         .to(torch.int32)[:, None], None, view_rows, None, "bitwise"),
        # row 0 takes ~21,000 adds of size ~1: a sum of size ~150, whose
        # f32 ulp is 1.5e-5, reached in another order
        ("f32 D16 L1 B8192 skewed ids", grad(n_big, 16), skewed(n_big, 1, view_rows),
         None, view_rows, None, (1e-4, 2e-3)),
        ("bf16 D16 L1 B8192 skewed ids", grad(n_big, 16, bf16),
         skewed(n_big, 1, view_rows), None, view_rows, None, (1e-2, 2e-3)),
        ("f32 g into a bf16 table, L8 mask", grad(8192, 16), ids(8192, 8, view_rows),
         mask01(8192, 8), view_rows, bf16, (1e-2, 1e-6)),
        ("f32 zero mask", grad(1024, 128), ids(1024, 8, 125001),
         torch.zeros(1024, 8, device="cuda"), 125001, None, "zero"),
        ("f32 ids out of range are dropped", grad(4096, 16),
         ids(4096, 2, 1200) - 100, None, 1000, None, (1e-5, 1e-5)),
        # the zoo's shapes: the 8-lane view of a width-1 table (1,000,016
        # rows) and ffm's unpacked gradient (1,000,001, 351), 1.4 GB in f32
        ("f32 D8 L1 B512", grad(n_small, 8), ids(n_small, 1, 1000016), None,
         1000016, None, (1e-5, 1e-6)),
        ("f32 D8 L1 B8192", grad(n_big, 8), ids(n_big, 1, 1000016), None,
         1000016, None, (1e-5, 1e-6)),
        ("f32 D8 L3 mask", grad(4096, 8), ids(4096, 3, 1000016), mask01(4096, 3),
         1000016, None, (1e-5, 1e-6)),
        ("bf16 D8 L1 B8192", grad(n_big, 8, bf16), ids(n_big, 1, 1000016), None,
         1000016, None, (1e-2, 1e-6)),
        ("bf16 D8 L3 mask", grad(4096, 8, bf16), ids(4096, 3, 1000016),
         mask01(4096, 3), 1000016, None, (1e-2, 1e-6)),
        ("f32 D351 L1 B512", grad(n_small, FFM_DIM), ids(n_small, 1, 1000001), None,
         1000001, None, (1e-5, 1e-6)),
        ("f32 D351 L1 B8192", grad(n_big, FFM_DIM), ids(n_big, 1, 1000001), None,
         1000001, None, (1e-5, 1e-6)),
        ("f32 D351 L3 mask", grad(4096, FFM_DIM), ids(4096, 3, 1000001),
         mask01(4096, 3), 1000001, None, (1e-5, 1e-6)),
        ("bf16 D351 L1 B8192", grad(n_big, FFM_DIM, bf16), ids(n_big, 1, 1000001),
         None, 1000001, None, (1e-2, 1e-6)),
        ("bf16 D351 L3 mask", grad(4096, FFM_DIM, bf16), ids(4096, 3, 1000001),
         mask01(4096, 3), 1000001, None, (1e-2, 1e-6)),
    ]
    # the sequence models' tables, as in check_k1: fill mode, so a negative id
    # is wrapped once and one still outside [0, R) dropped
    for dim, rows, n in ((64, 63001, 32 * 128 + 32), (1, 63001, 32), (4, 461499, 32 + 1600),
                         (32, 461529, 32 + 1600)):
        cases.append((f"fill f32 D{dim} L1 N{n}", grad(n, dim), ids(n, 1, rows), None,
                      rows, None, (1e-5, 1e-6)))
        cases.append((f"fill f32 D{dim} L1 out of range", grad(4096, dim),
                      ids(4096, 1, 3 * rows) - rows - 1, None, rows, None, (1e-5, 1e-6)))
    results, main_err = [], 0.0
    for name, grad_out, idx, mask, rows, dtype, tol in cases:
        mode = "fill" if name.startswith("fill") else "clip"
        out = gp.gather_pool_bwd(grad_out, idx, mask, rows, dtype, mode=mode)
        torch.cuda.synchronize()
        ref = gp.gather_pool_bwd_plain(grad_out, idx, mask, rows, dtype, mode=mode)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if out.dtype != ref.dtype or out.shape != ref.shape:
            ok = False
        elif tol == "bitwise":
            ok = torch.equal(out, ref)
        elif tol == "zero":
            ok = float(out.abs().max()) == 0.0
        else:
            ok = torch.allclose(out.float(), ref.float(), rtol=tol[0], atol=tol[1])
        results.append({
            "case": name, "n": idx.shape[0], "pool": idx.shape[1],
            "dim": grad_out.shape[1], "rows": rows, "max_abs_err": err, "ok": ok,
            "tolerance": tol if isinstance(tol, str) else {"rtol": tol[0], "atol": tol[1]},
        })
        if not ok:
            raise AssertionError(f"K1b disagrees with its plain version: {results[-1]}")
        if name.endswith(("L1 B512", "L1 B8192")) or name.startswith("fill"):
            main_err = max(main_err, err)
        del out, ref
    del cases
    emit({"k1b_checks": results, "card": card})

    # backward() through the autograd.Function (K1, then K1b) against
    # autograd through the plain version, on the card
    auto = []
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)), (bf16, (2e-2, 2e-2))):
        table = torch.randn(5000, 16, device="cuda", generator=g).to(dtype)
        idx, mask = ids(3000, 4, 5000), mask01(3000, 4)
        weight = torch.randn(3000, 16, device="cuda", generator=g)
        grads = []
        for fn in (gp.gather_pool, gp.gather_pool_plain):
            t = table.clone().requires_grad_()
            fwd, bwd = gp.gather_pool.launches, gp.gather_pool_bwd.launches
            (fn(t, idx, mask, torch.float32) * weight).sum().backward()
            launched = (gp.gather_pool.launches - fwd, gp.gather_pool_bwd.launches - bwd)
            if launched != ((1, 1) if fn is gp.gather_pool else (0, 0)):
                raise AssertionError(f"{fn.__name__}: launches {launched}")
            grads.append(t.grad.float())
        torch.cuda.synchronize()
        err = float((grads[0] - grads[1]).abs().max())
        # bf16: the plain path's index_select backward adds in bf16, K1b in
        # f32 rounded once
        if not torch.allclose(grads[0], grads[1], rtol=tol[0], atol=tol[1]):
            raise AssertionError(f"autograd through K1/K1b, {dtype}: max err {err}")
        auto.append({"dtype": str(dtype), "max_abs_err": err,
                     "tolerance": {"rtol": tol[0], "atol": tol[1]}})
    emit({"autograd_checks": auto, "card": card})
    return main_err


def time_ms(fn, sets, iters: int, hold_ms: float = 0.0) -> float:
    """Mean ms per call over ``iters`` calls cycling through ``sets`` (fresh
    ids each call, as in serving), timed with CUDA events after a warm-up.

    With ``hold_ms`` the card first spins that long, so the host queues
    every call before the first runs: the events then time the card's work
    alone.  Without it they time calls as the host issues them."""
    for s in sets[:3]:
        fn(s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 1e-3 * SM_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _id_sets(n: int, vocab: int, g, min_sets: int = 4) -> list:
    """Enough distinct (n, 1) id sets that one cycle through them touches
    more rows than L2 holds."""
    n_sets = max(min_sets, math.ceil(64 * 13312 / n))
    return [torch.randint(0, vocab, (n, 1), device="cuda", generator=g,
                          dtype=torch.int32) for _ in range(n_sets)]


def _timed(fns, sets, iters: int):
    """(device ms, call ms) per function: as the host issues the calls, then
    with the host queued ahead so that the card's work alone is timed."""
    call = {k: time_ms(fn, sets, iters) for k, fn in fns.items()}
    device = {k: time_ms(fn, sets, iters, hold_ms=4 * iters * call[k] + 5)
              for k, fn in fns.items()}
    return device, {k[:-3] if k != "ms" else "kernel": v for k, v in call.items()}


# the sequence models' lookups at batch 32, one K1 launch each (fill mode):
# (shape, rows, row width D, ids N per call, how the ids fall)
SEQ_SHAPES = (
    ("din item_emb", 63001, 64, 32 * 128 + 32, "uniform"),  # history and target in one call
    ("din item_b", 63001, 1, 32, "uniform"),  # 4-byte rows: both kernels' scalar path
    ("dsin brand_emb", 461499, 4, 32 + 32 * 5 * 10, "uniform"),
    ("dmr brand_emb", 461529, 32, 32 + 32 * 50, "uniform"),
)


def _fill_ids(kind: str, rows: int, n: int, g) -> torch.Tensor:
    """(n, 1) int32 ids of a ``*_SHAPES`` entry: ``uniform`` over the table,
    ``zeros``, ``period P`` (0..P-1 repeated: (B, T) position ids), or
    ``half last`` (uniform, every other id the last row: padding clipped
    onto it)."""
    if kind == "zeros":
        return torch.zeros((n, 1), dtype=torch.int32, device="cuda")
    if kind.startswith("period"):
        period = int(kind.split()[1])
        return (torch.arange(n, device="cuda", dtype=torch.int32) % period)[:, None]
    ids = torch.randint(0, rows, (n, 1), device="cuda", generator=g, dtype=torch.int32)
    if kind == "half last":
        ids[1::2] = rows - 1
    return ids


def time_launch_floor(gp, iters: int = 500) -> float:
    """ms per launch of the empty kernel of ``csrc/gather_pool.cu``, timed as
    the kernels are (CUDA events, the host queued ahead): no kernel's time
    goes under it, whatever its byte bound.  ``iters`` stays under the depth
    of the launch queue (about a thousand): beyond it the host, at ~18 us a
    ``ctypes`` call, would be what is timed."""
    device = torch.device("cuda")
    call = time_ms(lambda _: gp.empty_launch(device), [None], iters)
    return time_ms(lambda _: gp.empty_launch(device), [None], iters,
                   hold_ms=4 * iters * call + 5)


def time_dedup(seed: int, vocabs) -> list:
    """Phase 10: the dedup of one batch's physical rows, on the host
    (``host_dedup``: numpy, what the feed thread runs) and on the card
    (``dedup_rows``: sort + cumsum; CUDA events, host queued ahead)."""
    from paddlerec_tpu_torch.ops.sparse_update import dedup_rows, host_dedup

    rng = np.random.RandomState(seed + 6)
    out = []
    for vocab in vocabs:
        for batch in BATCHES:
            n = batch * SLOTS
            sets = [rng.randint(1, vocab, (batch, SLOTS)).astype(np.int64)
                    for _ in range(8)]
            host_dedup(sets[0], vocab, 8)
            t0 = time.perf_counter()
            for ids in sets:
                uniq, _ = host_dedup(ids, vocab, 8)
            host_ms = (time.perf_counter() - t0) * 1e3 / len(sets)
            rows = (vocab + 7) // 8
            phys = [torch.from_numpy((ids.reshape(-1) % vocab // 8).astype(np.int32)).cuda()
                    for ids in sets]
            call = time_ms(lambda p: dedup_rows(p, rows), phys, 40)
            card_ms = time_ms(lambda p: dedup_rows(p, rows), phys, 40,
                              hold_ms=4 * 40 * call + 5)
            got = dedup_rows(phys[-1], rows)[0].cpu().numpy()
            real = int((uniq != np.iinfo(np.int32).max).sum())
            if not np.array_equal(got[:real], uniq[:real]) or np.any(got[real:] != rows):
                raise AssertionError("dedup_rows on the card disagrees with host_dedup")
            out.append({"vocab": vocab, "batch": batch, "n": n, "unique_rows": real,
                        "host_dedup_ms": host_ms, "dedup_rows_card_ms": card_ms,
                        "dedup_rows_call_ms": call})
    return out


def sparse_checks(gp, seed: int, card: str) -> None:
    """Phase 9: each row-wise rule on the card against the port's own CPU run
    of the same inputs (two steps, f32 and bf16 table, N = 13,312 positions
    of a vocab-1,000,001 table), and ``stochastic_round_bf16`` bitwise
    against the CPU given the noise."""
    from paddlerec_tpu_torch.ops import sparse_update as su

    vocab, pack, n = 1000001, 8, 512 * SLOTS
    rows = (vocab + pack - 1) // pack
    rng = np.random.RandomState(seed + 7)
    results = []
    rules = {
        "adagrad_compact": (su.apply_sparse_adagrad_compact, su.rowwise_adagrad_init),
        "adam_compact": (su.apply_sparse_adam_compact, su.rowwise_adam_init),
        "adagrad": (su.apply_sparse_adagrad, su.rowwise_adagrad_init),
        "adam": (su.apply_sparse_update, su.rowwise_adam_init),
    }
    for dtype in (torch.float32, torch.bfloat16):
        start = torch.from_numpy((rng.randn(rows, 128) * 0.05).astype(np.float32)).to(dtype)
        steps = []
        for _ in range(2):
            ids = rng.randint(0, 3 * vocab, n).astype(np.int64)
            ids[: n // 8] = ids[n // 8: n // 4]  # duplicates
            g = (rng.randn(n, 16) * 0.1).astype(np.float32)
            g[:, 10:] = 0.0
            steps.append((ids, torch.from_numpy(g)))
        for name, (fn, init) in rules.items():
            tables = {}
            for device in ("cpu", "cuda"):
                table = start.clone().to(device)
                state = init(table)
                before = gp.gather_pool_bwd.launches
                for ids, g in steps:
                    hashed = ids % vocab
                    sub = torch.from_numpy((hashed % pack).astype(np.int32)).to(device)
                    if name.endswith("compact"):
                        uniq, slot = su.host_dedup(ids, vocab, pack)
                        fn(table, state, g.to(device), torch.from_numpy(uniq).to(device),
                           torch.from_numpy(slot).to(device), 0.05, sub=sub)
                    else:
                        phys = torch.from_numpy((hashed // pack).astype(np.int32)).to(device)
                        fn(table, state, g.to(device), phys, 0.05, sub=sub)
                launched = gp.gather_pool_bwd.launches - before
                if launched != (2 if device == "cuda" else 0):
                    raise AssertionError(f"{name} on {device}: {launched} K1b launches")
                tables[device] = (table.cpu(), [t.cpu() for t in state])
            torch.cuda.synchronize()
            (t_cpu, s_cpu), (t_card, s_card) = tables["cpu"], tables["cuda"]
            err = float((t_card.float() - t_cpu.float()).abs().max())
            differ = int((t_card != t_cpu).sum())
            state_err = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(s_card, s_cpu))
            moved = float((t_cpu.float() - start.float()).abs().max())
            # The sum per row arrives in another order on the card (atomics),
            # and the card's rsqrt, sqrt and pow are not the host's to the
            # last bit.  Adagrad: f32 entries within 1e-6.  Adam: 1 - b2**count
            # cancels to 1e-3, so a last bit of the power is 6e-5 of the
            # step (lr = 0.05): 5e-6.  A bf16 entry may then land on the
            # other side of a rounding (one ulp of |p| <= 0.3: 2e-3): few of
            # the touched entries (2 steps x n positions x 10 lanes) with
            # Adagrad, up to a tenth with Adam.
            adam = "adam" in name
            touched = 2 * n * 10
            ok = moved > 1e-3 and state_err <= 1e-6 and (
                err <= (5e-6 if adam else 1e-6) if dtype == torch.float32
                else err <= 2e-3 and differ <= (0.1 if adam else 1e-3) * touched)
            results.append({"rule": name, "table_dtype": str(dtype), "n": n,
                            "max_abs_err_table": err, "entries_that_differ": differ,
                            "max_abs_err_state": state_err, "ok": ok})
            if not ok:
                raise AssertionError(f"row-wise rule on the card vs the CPU: {results[-1]}")
    x = torch.from_numpy((rng.randn(1 << 20) * np.exp(rng.randn(1 << 20) * 3)).astype(np.float32))
    noise = torch.from_numpy(rng.randint(0, 1 << 16, 1 << 20).astype(np.int32))
    same = torch.equal(su.stochastic_round_bf16(x.cuda(), noise.cuda()).cpu(),
                       su.stochastic_round_bf16(x, noise))
    if not same:
        raise AssertionError("stochastic_round_bf16: card and CPU differ given the noise")
    emit({"sparse_checks": results, "stochastic_round_bf16_bitwise_vs_cpu": same,
          "card": card})


@_uncounted
def check_sparse_lookup(gp, module, vocab: int, seed: int, card: str) -> dict:
    """Phase 9, on the full-width table: the external lookup through K1 and
    the per-row gradient sum through K1b against their plain versions, at
    N = 212,992 and 13,312 positions with ids over the whole vocabulary."""
    from paddlerec_tpu_torch.ops import sparse_update as su
    from paddlerec_tpu_torch.ops.packed_embedding import logical_view

    emb = module.embedding
    rng = np.random.RandomState(seed + 8)
    g_dev = torch.Generator(device="cuda").manual_seed(seed + 8)
    out = {"k1_err": 0.0, "k1b_err": 0.0, "cases": []}
    for batch in reversed(BATCHES):
        n = batch * SLOTS
        ids = rng.randint(1, 3 * vocab, (batch, SLOTS)).astype(np.int64)
        before = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
        vecs = emb(torch.from_numpy(ids).cuda())
        weight = torch.randn(vecs.shape, device="cuda", generator=g_dev)
        (vecs * weight).sum().backward()
        g = emb.take_delta_grad()
        hashed = torch.from_numpy(ids.reshape(-1) % vocab).cuda()
        view = logical_view(emb.embedding.detach(), emb.embedding_dim)
        plain = gp.gather_pool_plain(view, hashed.to(torch.int32)[:, None], None,
                                     torch.float32)[:, :emb.embedding_dim]
        if emb.embedding.grad is not None or vecs.dtype != torch.float32:
            raise AssertionError("external lookup: a table gradient, or not float32")
        if not torch.equal(vecs.detach().reshape(n, -1), plain):
            raise AssertionError("external lookup through K1 differs from its plain version")
        if not torch.equal(g[:, :emb.embedding_dim], weight.reshape(n, -1)):
            raise AssertionError("the captured gradient is not the vectors' gradient")
        uniq, slot = su.host_dedup(ids, vocab, 8)
        real = int((uniq != su.SENTINEL).sum())
        slot_t = torch.from_numpy(slot).cuda()
        sub = (hashed % 8).to(torch.int32)
        summed = su._grad_sum(g, sub, slot_t, real)
        lanes = su._lane_ids(slot_t, sub, 16)
        ref = gp.gather_pool_bwd_plain(g, lanes, None, real * 8).view(real, 128)
        torch.cuda.synchronize()
        launched = (gp.gather_pool.launches - before[0],
                    gp.gather_pool_bwd.launches - before[1])
        if launched != (1, 1):
            raise AssertionError(f"lookup and gradient sum launched K1, K1b {launched}")
        err = float((summed - ref).abs().max())
        # a lane group that one position touched: bitwise
        once = torch.bincount(lanes.reshape(-1).long(), minlength=real * 8) == 1
        bitwise_once = torch.equal(summed.view(-1, 16)[once], ref.view(-1, 16)[once])
        if not bitwise_once or not torch.allclose(summed, ref, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"per-row gradient sum through K1b: max err {err}")
        out["k1b_err"] = max(out["k1b_err"], err)
        out["cases"].append({"n": n, "unique_rows": real, "k1_bitwise": True,
                             "k1b_bitwise_where_touched_once": bitwise_once,
                             "k1b_max_abs_err": err,
                             "k1b_tolerance": {"rtol": 1e-5, "atol": 1e-6}})
    emit({"sparse_lookup_checks": out["cases"], "vocab": vocab,
          "table": list(emb.embedding.shape), "table_dtype": str(emb.embedding.dtype),
          "card": card})
    return out


def train_sparse(gp, work: str, seed: int, card: str) -> dict:
    """Phase 9: ``configs/rank/deepfm/config_bigdata.yaml`` at its full
    width through ``Trainer.train()``, ``evaluate()``, the checkpoint,
    ``tools.export`` and ``run_predict``; then 8 steps each of the dnn and
    wide_deep ``config_bigdata.yaml``."""
    from paddlerec_tpu_torch.core.config import Config, load_config
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.data.schema import schema_from_config
    from paddlerec_tpu_torch.data.slot_reader import SlotDataset, list_data_files
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.trainer import Trainer

    cfg = load_config(BIGDATA.format("deepfm"))
    vocab = int(cfg.hyper("sparse_feature_number"))
    batch = int(cfg.runner("train_batch_size"))
    data = os.path.join(work, "sparse_train")
    write_sparse_train_data(data, TRAIN_STEPS[batch] * batch, vocab, seed + 9)

    def run_config(model: str, **extra):
        flat = dict(load_config(BIGDATA.format(model)).to_dict())
        flat.update({
            "runner.train_data_dir": data, "runner.test_data_dir": data,
            "runner.model_save_path": None, "runner.infer_load_path": None,
            "runner.print_interval": 4, "runner.feed_superbatch": 4,
            "runner.wire_format": "compact", "runner.reader_type": "",
        })
        flat.update(extra)
        return Config(flat)

    # the first 5 steps, card against CPU, at the vocabulary the CPU can hold
    # and with round-to-nearest (the two devices draw different noise)
    small = os.path.join(work, "sparse_small")
    write_sparse_train_data(small, 5 * batch, 1000001, seed + 10, files=1)
    first = first_steps_vs_cpu(gp, run_config("deepfm", **{
        "runner.train_data_dir": small,
        "hyper_parameters.sparse_feature_number": 1000001,
        "hyper_parameters.sparse_update_stochastic_round": False}), seed)
    emit({"train_sparse_first_steps_vs_cpu": first, "card": card})

    ckpt = os.path.join(work, "sparse_ckpt")
    # two epochs over the same rows: the second must read lower than the first
    run_cfg = run_config("deepfm", **{"runner.model_save_path": ckpt,
                                      "runner.infer_load_path": ckpt,
                                      "runner.epochs": 2})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = Trainer(run_cfg)
    trainer.init_state(seed=seed)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    table = trainer.state.module.embedding.embedding
    acc = trainer.state.extra["embedding/embedding_delta"].acc
    held = table.numel() * table.element_size() + acc.numel() * acc.element_size()
    if tuple(table.shape) != (12500001, 128) or table.dtype != torch.bfloat16:
        raise AssertionError(f"the table is {tuple(table.shape)} {table.dtype}")
    lookup = check_sparse_lookup(gp, trainer.state.module, vocab, seed, card)
    torch.cuda.reset_peak_memory_stats()
    run = run_training(gp, run_cfg, seed, trainer=trainer, min_steps=24)
    run["free_disk_bytes_after_checkpoints"] = shutil.disk_usage(work).free
    peak = torch.cuda.max_memory_allocated() - base
    moments = [k for v in trainer.state.opt_state.values() if isinstance(v, dict)
               for k in v if "embedding" in k]
    if table.grad is not None or moments:
        raise AssertionError(f"a table gradient or dense moments exist: {moments}")
    if peak > held + GB:
        raise AssertionError(
            f"peak allocation {peak} bytes above table + row state + 1 GB ({held + GB})")
    run.update({"vocab": vocab, "table_shape": list(table.shape),
                "table_and_row_state_bytes": held, "peak_allocated_bytes": peak,
                "peak_above_table_and_state_bytes": peak - held,
                "allocated_before_bytes": base, "init_seconds": init_seconds,
                "row_rule": trainer.model_def._sparse_update_rule(),
                "stochastic_round": bool(run_cfg.hyper("sparse_update_stochastic_round"))})
    emit({"train_sparse": run, "card": card})

    # export the checkpoint, serve the artifact
    t0 = time.perf_counter()
    export_dir = os.path.join(work, "sparse_export")
    export_model(Config({**run_cfg.to_dict(),
                         "runner.model_init_path": os.path.join(ckpt, "1")}), export_dir)
    shutil.rmtree(ckpt)
    text = os.path.join(work, "sparse_text")
    write_criteo_sample(text, num_lines=ROWS, num_files=4, vocab=vocab, seed=seed)
    gp.gather_pool.launches = 0
    outputs, report = run_predict(export_dir, text, batch)
    served_launches = gp.gather_pool.launches
    preds = np.concatenate(outputs)
    own = []
    dataset = SlotDataset(list_data_files(text), schema_from_config(run_cfg), batch,
                          drop_last=False)
    with torch.no_grad():
        for host_batch in dataset:
            aux = trainer.model_def.infer_forward(
                trainer.state.module, to_tensors(host_batch, trainer.device))
            own.append(aux["predictions"].cpu().numpy()[host_batch["mask"] > 0])
    err = float(np.abs(preds - np.concatenate(own)).max())
    # the artifact's plain lookup hands out bf16 vectors where the training
    # module's external lookup gave float32 ones
    if preds.shape != (ROWS,) or not np.all((preds > 0) & (preds < 1)) or err > 2e-2:
        raise AssertionError(f"the exported sparse run serves wrongly: max err {err}")
    if served_launches != math.ceil(ROWS / batch):
        raise AssertionError(f"run_predict launched K1 {served_launches} times")
    emit({"export_sparse": {"seconds_export_and_predict": time.perf_counter() - t0,
                            "rows": ROWS, "max_abs_err_vs_training_module": err,
                            "k1_launches": served_launches, **report}, "card": card})
    shutil.rmtree(export_dir)
    del trainer, table, acc
    torch.cuda.empty_cache()

    runs = {"deepfm": run}
    for model in ("dnn", "wide_deep"):
        short = os.path.join(work, f"sparse_{model}")
        write_sparse_train_data(short, 8 * batch, vocab, seed + 11, files=2)
        runs[model] = run_training(
            gp, run_config(model, **{"runner.train_data_dir": short,
                                     "runner.test_data_dir": short}),
            seed, check_fall=False)
        runs[model]["model"] = model
        emit({"train_sparse": runs[model], "card": card})
        torch.cuda.empty_cache()
    return {"first": first, "runs": runs, "lookup": lookup,
            "served_launches": served_launches}


class LossLines(logging.Handler):
    """Collects the ``loss:`` and ``avg_reader_cost:`` values of the
    trainer's log lines."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.losses, self.reader_costs = [], []

    def emit(self, record):
        line = record.getMessage()
        found = re.search(r"loss: (-?[0-9.]+|nan|inf)", line)
        if found and line.startswith("epoch:"):
            self.losses.append(float(found.group(1)))
            self.reader_costs.append(float(
                re.search(r"avg_reader_cost: ([0-9.]+) sec", line).group(1)))


def write_train_data(data_dir: str, rows: int, vocab: int, seed: int) -> None:
    """Criteo-shaped rows with the planted signal of ``write_criteo_sample``,
    as four slotbin files."""
    from paddlerec_tpu_torch.data.binary import write_slotbin
    from paddlerec_tpu_torch.data.synthetic import synthetic_batch

    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    for i in range(4):
        part = synthetic_batch(rng, rows // 4, vocab=vocab)
        write_slotbin(os.path.join(data_dir, f"part-{i}.bin"), part["label"],
                      part["sparse"].astype(np.int32), part["dense"])


def write_sparse_train_data(data_dir: str, rows: int, vocab: int, seed: int,
                            files: int = 4, hot: int = 4096) -> None:
    """Criteo-shaped rows for a production-sized vocabulary, as slotbin
    files: ids over the whole of ``[1, vocab)``, half of them uniform and
    half drawn from ``hot`` ids per slot (themselves spread over the whole
    vocabulary), so that some ids come back often enough to be learned in a
    few steps, as the head of a real id distribution does.  The label
    carries the planted signal of ``synthetic_batch``."""
    from paddlerec_tpu_torch.data.binary import write_slotbin

    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    pools = rng.randint(1, vocab, size=(SLOTS, hot)).astype(np.int64)
    for i in range(files):
        n = rows // files
        sparse = rng.randint(1, vocab, size=(n, SLOTS)).astype(np.int64)
        picks = pools[np.arange(SLOTS), rng.randint(0, hot, size=(n, SLOTS))]
        sparse = np.where(rng.rand(n, SLOTS) < 0.5, picks, sparse)
        dense = rng.rand(n, 13).astype(np.float32)
        w = ((sparse * 2654435761) % 1000) / 1000.0 - 0.5
        score = w.mean(axis=1) * 8.0 + (dense.mean(axis=1) - 0.5) * 2.0
        label = (rng.rand(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.float32)
        write_slotbin(os.path.join(data_dir, f"part-{i}.bin"), label,
                      sparse.astype(np.int32), dense)


def train_config(cfg, work: str, batch: int, **extra):
    from paddlerec_tpu_torch.core.config import Config

    flat = dict(cfg.to_dict())
    flat.update({
        "runner.train_data_dir": os.path.join(work, f"train_{batch}"),
        "runner.test_data_dir": os.path.join(work, f"train_{batch}"),
        "runner.model_save_path": os.path.join(work, f"ckpt_{batch}"),
        "runner.infer_load_path": os.path.join(work, f"ckpt_{batch}"),
        "runner.train_batch_size": batch, "runner.infer_batch_size": batch,
        "runner.epochs": 1, "runner.print_interval": 8,
        "runner.feed_superbatch": 4, "runner.wire_format": "compact",
    })
    flat.update(extra)
    return Config(flat)


def first_steps_vs_cpu(gp, cfg, seed: int, steps: int = 5) -> dict:
    """The first ``steps`` train steps on the card against the port's own
    CPU run from the same parameters and the same batches (a sparse run's
    batches deduped on the host, as the feed does)."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer

    host = Trainer(cfg, device="cpu")
    host.init_state(seed=seed)
    card = Trainer(cfg)
    card.init_state(seed=seed)
    card.state.module.load_state_dict(host.state.module.state_dict())
    batch = int(cfg.runner("train_batch_size"))
    dataset = card.make_dataset(cfg.runner("train_data_dir"), batch)
    batches = [card.model_def.augment_batch_host(b)
               for b, _ in zip(dataset, range(steps))]
    gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
    losses = {}
    for name, trainer in (("cuda", card), ("cpu", host)):
        ms, losses[name] = trainer._init_metric_state(), []
        for b in batches:
            ms, loss = trainer.train_step(to_tensors(b, trainer.device), ms)
            losses[name].append(float(loss))
    launches = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
    if launches != (steps, steps):
        raise AssertionError(f"{steps} steps on the card launched K1, K1b {launches}")
    err = float(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"])).max())
    table_err = float((card.state.module.embedding.embedding.detach().cpu().float()
                       - host.state.module.embedding.embedding.detach().float()).abs().max())
    if not np.all(np.isfinite(losses["cuda"])) or err > 1e-5:
        raise AssertionError(f"card and CPU losses differ by {err}: {losses}")
    return {"batch_size": batch, "steps": steps, "sparse_update": card.sparse,
            "vocab": int(cfg.hyper("sparse_feature_number")),
            "loss_cuda": losses["cuda"],
            "max_abs_err_loss_vs_cpu": err, "max_abs_err_table_vs_cpu": table_err,
            "k1_launches": launches[0], "k1b_launches": launches[1]}


def table_dtype(module) -> str:
    """The dtype of the module's first embedding table."""
    return next((str(p.dtype) for name, p in module.named_parameters()
                 if name.endswith("embedding")), None)


def run_training(gp, cfg, seed: int, check_fall: bool = True, trainer=None,
                 min_steps: int = 8, tables: int = 1, check_auc: bool = True,
                 eval_tables: Optional[int] = None) -> dict:
    """``Trainer.train()`` then ``evaluate()`` through the normal entry
    points; the kernels' counts are read around each: one K1 launch per
    forward and one K1b launch per step for each of the model's ``tables``
    (``eval_tables`` K1 launches per evaluated batch where the inference
    forward reads fewer: ensfm's).  The model's metric (``auc``, or ``acc``
    for an accuracy model) must be above 0.5 or 0; ``check_auc`` is switched
    off only for a run whose CPU twin's head died, and a model without a
    streaming metric (``metrics = "none"``) has none to check."""
    from paddlerec_tpu_torch.core.config import resolve_path
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    batch = int(cfg.runner("train_batch_size"))
    epochs = int(cfg.runner("epochs"))
    if trainer is None:
        trainer = Trainer(cfg)
        trainer.init_state(seed=seed)
    lines = LossLines()
    logger.addHandler(lines)
    gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
    gp.gather_pool.launches_by_dim.clear()
    gp.gather_pool_bwd.launches_by_dim.clear()
    try:
        t0 = time.perf_counter()
        metrics = trainer.train()
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(lines)
    steps = trainer.state.step
    launches = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
    if launches != (tables * steps, tables * steps) or steps < min_steps:
        raise AssertionError(f"{steps} train steps launched K1, K1b {launches}")
    losses = lines.losses
    if len(losses) < 2 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"batch {batch}: losses {losses}")
    half = len(losses) // 2
    if check_fall and not np.mean(losses[half:]) < np.mean(losses[:half]):
        raise AssertionError(f"batch {batch}: the loss did not fall: {losses}")
    examples = steps * batch
    gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
    saved = bool(cfg.runner("model_save_path"))
    evaluated = trainer.evaluate(epoch_tag=epochs - 1 if saved else None)
    eval_launches = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
    # the host batches evaluate() read, tail included
    eval_batches = sum(1 for _ in trainer.make_dataset(
        resolve_path(cfg, "runner.test_data_dir"), int(cfg.runner("infer_batch_size", 32)),
        drop_last=False))
    if eval_launches != ((tables if eval_tables is None else eval_tables) * eval_batches, 0):
        raise AssertionError(f"{eval_batches} eval batches launched K1, K1b {eval_launches}")
    metric = trainer.model_def.metrics
    floor = 0.5 if metric == "auc" else 0.0
    if metric != "none" and not (np.isfinite(evaluated[metric])
                                 and (evaluated[metric] > floor or not check_auc)):
        raise AssertionError(f"evaluate: {evaluated}")
    return {
        "batch_size": batch, "steps": steps, "epochs": epochs,
        "table_dtype": table_dtype(trainer.state.module),
        "sparse_update": trainer.sparse,
        "logged_losses": losses,
        "avg_reader_cost_ms": 1e3 * float(np.mean(lines.reader_costs)),
        "train_seconds_with_checkpoints": seconds,
        "last_epoch_seconds": metrics["epoch_time"],
        "last_epoch_examples_per_s": metrics["ips"],
        "last_epoch_steps_per_s": metrics["ips"] / batch,
        "examples": examples, f"train_{metric}_last_epoch": metrics.get(metric),
        "k1_launches": launches[0], "k1b_launches": launches[1],
        # train() and evaluate() together, by the row width D of the launch
        "k1_launches_by_dim": dict(gp.gather_pool.launches_by_dim),
        "k1b_launches_by_dim": dict(gp.gather_pool_bwd.launches_by_dim),
        "eval": {metric: evaluated.get(metric), "total_ins": evaluated.get("total_ins"),
                 "examples_per_s": evaluated["ips"], "batches": eval_batches,
                 "k1_launches": eval_launches[0]},
    }


@_uncounted
def profile_train(cfg, batch_size: int, seed: int, iters: int = 20) -> dict:
    """Phases 8 and 10: ``torch.profiler`` over ``iters`` train steps on one
    device batch (a sparse run's deduped on the host, with its count): wall
    and device time per step, the card's idle share (profiler on), kernels
    per step and the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    trainer.init_state(seed=seed)
    from paddlerec_tpu_torch.train.trainer import _count_uniq

    host_batch = trainer.model_def.augment_batch_host(
        trainer.model_def.example_batch(batch_size))
    batch = to_tensors(_count_uniq(host_batch), trainer.device)
    ms = trainer._init_metric_state()
    for _ in range(3):
        ms, _ = trainer.train_step(batch, ms)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            ms, loss = trainer.train_step(batch, ms)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # the same steps with the profiler off: the wall time a user sees
    t0 = time.perf_counter()
    for _ in range(iters):
        ms, loss = trainer.train_step(batch, ms)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # the step's parts, each looped alone and ended by a synchronise: wall
    # time per call, which is the host's where the card waits for it
    module, model_def = trainer.state.module, trainer.model_def

    def forward_backward():
        module.zero_grad(set_to_none=True)
        loss, aux = model_def.train_forward(module, batch)
        loss.backward()
        if trainer.sparse:
            aux["delta_grads"] = {
                k: m.take_delta_grad() for k, m in model_def.sparse_taps(module).items()}
        return aux

    def looped(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            result = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters, result

    parts = {}
    parts["forward"], _ = looped(lambda: model_def.train_forward(module, batch))
    parts["forward_backward"], aux = looped(forward_backward)
    parts["optimizer"], _ = looped(trainer.state.apply_gradients)
    if trainer.state.extra is not None:
        parts["row_update"], _ = looped(lambda: model_def.apply_sparse_updates(
            module, trainer.state.extra, aux["delta_grads"], batch,
            rng=trainer._step_rng))
    parts["metrics"], _ = looped(lambda: model_def.update_metric_state(ms, aux))
    averages = prof.key_averages()  # parsing the events costs seconds: once
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    return {
        "model": cfg.runner("model"),
        "batch_size": batch_size, "steps": iters, "sparse_update": trainer.sparse,
        "vocab": cfg.hyper("sparse_feature_number"),
        "table_dtype": table_dtype(module),
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_profiler_off": plain_wall_ms,
        "device_ms_per_step": device_ms if kernels else "not measured",
        "device_idle_share": 1 - device_ms / wall_ms if kernels else "not measured",
        "device_idle_share_profiler_off":
            1 - device_ms / plain_wall_ms if kernels else "not measured",
        "kernels_per_step": sum(e.count for e in kernels) / iters,
        "wall_ms_per_part": parts,
        "final_loss": float(loss),
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3 / iters,
                         "calls_per_step": e.count / iters} for e in top],
        # where the host spends the step (self time of the ops it calls,
        # profiler on; Python between the ops is not in this list)
        "top_host_ops": [{"name": e.key[:60],
                          "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / iters,
                          "calls_per_step": e.count / iters} for e in host],
    }


def dead_head(losses) -> bool:
    """Whether a run's last three logged losses are log 2: logits of 0 on
    every row, which is what a head of dead ReLU units gives."""
    return bool(np.allclose(losses[-3:], math.log(2), rtol=0, atol=1e-6))


def zoo_config(model: str):
    from paddlerec_tpu_torch.core.config import load_config

    return load_config(os.path.join(ROOT, "configs", "rank", model, "config.yaml"))


ZOO_ATOL = 1e-5  # card against CPU, every model: float32 sums in another order


def live_trainer(cfg, seed: int, batch, tries: int = 8):
    """A CPU trainer initialised from the first seed at or after ``seed``
    from which ``batch`` gives some parameter a gradient, and that seed.  A
    head that starts dead (dlrm's two ReLU units at 0 on every row: every
    prediction exactly 0.5, no gradient at all) would leave the comparisons
    that follow nothing to compare."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer

    for s in range(seed, seed + tries):
        host = Trainer(cfg, device="cpu")
        host.init_state(seed=s)
        module = host.state.module
        loss, _ = host.model_def.train_forward(module, to_tensors(batch, host.device))
        loss.backward()
        alive = any(p.grad is not None and bool(p.grad.any())
                    for p in module.parameters())
        module.zero_grad(set_to_none=True)
        if alive:
            return host, s
    raise AssertionError(f"{cfg.runner('model')}: no gradient from "
                         f"seeds {seed}..{seed + tries - 1}")


def ctr_zoo(gp, seed: int, card: str) -> dict:
    """Phase 11: every model of the zoo at the full width of its own config,
    a module on the card and its twin on the CPU from one seed; one forward
    and three train steps at batch 512 on the same batches.  Returns the
    launch totals and each model's seed (see ``live_trainer``)."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.data.synthetic import synthetic_batch
    from paddlerec_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(seed + 12)
    batches = [synthetic_batch(rng, BATCHES[0], vocab=1000001) for _ in range(4)]
    results, failed, totals, seeds = [], [], [0, 0], {}
    for model in ZOO:
        cfg = zoo_config(model)
        tables = ZOO_TABLES.get(model, 1)
        t0 = time.perf_counter()
        host, seeds[model] = live_trainer(cfg, seed, batches[0])
        chip = Trainer(cfg)
        chip.init_state(seed=seeds[model])
        chip.state.module.load_state_dict(host.state.module.state_dict())
        preds, losses, launched = {}, {}, {}
        for name, trainer in (("cuda", chip), ("cpu", host)):
            gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
            first = to_tensors(batches[0], trainer.device)
            with torch.no_grad():
                aux = trainer.model_def.infer_forward(trainer.state.module, first)
            preds[name] = aux["predictions"].cpu().numpy()
            forward = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
            ms, losses[name] = trainer._init_metric_state(), []
            for b in batches[1:]:
                ms, loss = trainer.train_step(to_tensors(b, trainer.device), ms)
                losses[name].append(float(loss))
            launched[name] = (forward, (gp.gather_pool.launches - forward[0],
                                        gp.gather_pool_bwd.launches))
        totals[0] += launched["cuda"][0][0] + launched["cuda"][1][0]
        totals[1] += launched["cuda"][1][1]
        steps = len(batches) - 1
        want = ((tables, 0), (tables * steps, tables * steps))
        if launched["cuda"] != want or launched["cpu"] != ((0, 0), (0, 0)):
            raise AssertionError(f"{model}: K1, K1b launches {launched}, expected {want}")
        pred_err = float(np.abs(preds["cuda"] - preds["cpu"]).max())
        loss_err = float(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"])).max())
        ok = bool(np.all(np.isfinite(preds["cuda"])) and np.all(np.isfinite(losses["cuda"]))
                  and preds["cuda"].shape == (BATCHES[0],) and len(set(losses["cuda"])) > 1
                  and pred_err <= ZOO_ATOL and loss_err <= ZOO_ATOL)
        results.append({
            "model": model, "ok": ok, "atol": ZOO_ATOL, "seed": seeds[model],
            "max_abs_err_predictions": pred_err,
            "predictions_spread": float(np.ptp(preds["cuda"])),
            "max_abs_err_loss": loss_err, "loss_cuda": losses["cuda"],
            "k1_per_forward": launched["cuda"][0][0],
            "k1b_per_step": launched["cuda"][1][1] // steps,
            "parameters": sum(p.numel() for p in chip.state.module.parameters()),
            "seconds": time.perf_counter() - t0})
        if not ok:
            failed.append(model)
        del host, chip, trainer, ms, aux, first, loss
        gc.collect()
        torch.cuda.empty_cache()
    emit({"ctr_zoo": results, "batch_size": BATCHES[0], "card": card})
    if failed:
        raise AssertionError(f"card and CPU disagree for {failed}")
    return {"k1_launches": totals[0], "k1b_launches": totals[1], "seeds": seeds}


def zoo_paths(gp, work: str, data_dir: str, cpu_rows: int, seeds: dict,
              card: str) -> dict:
    """Phase 12: dcn_v2, xdeepfm, dlrm and ffm at full width through
    ``export_model``, ``run_predict`` (over the slot text in ``data_dir``) and
    ``Trainer.train()`` / ``evaluate()`` over the slotbin rows written for
    phase 6 at batch 8192; dcn_v2 once more as a sparse run.  ``seeds`` are
    ``ctr_zoo``'s: each model starts from parameters that take a gradient."""
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    batch = BATCHES[-1]
    forwards = math.ceil(cpu_rows / batch)
    totals, runs = [0, 0], {}
    for model in ZOO_PATHS:
        cfg, tables, seed = zoo_config(model), ZOO_TABLES.get(model, 1), seeds[model]
        export_dir = os.path.join(work, f"export_{model}")
        t0 = time.perf_counter()
        export_model(cfg, export_dir, seed=seed)
        cpu_out, _ = run_predict(export_dir, data_dir, batch, device="cpu")
        gp.gather_pool.launches = 0
        out, report = run_predict(export_dir, data_dir, batch)
        launched = gp.gather_pool.launches
        shutil.rmtree(export_dir)
        preds, cpu_preds = np.concatenate(out), np.concatenate(cpu_out)
        err = float(np.abs(preds - cpu_preds).max())
        if launched != tables * forwards:
            raise AssertionError(f"{model}: {launched} K1 launches for {forwards} forwards")
        if (preds.shape != (cpu_rows,) or not np.all((preds >= 0) & (preds <= 1))
                or not np.ptp(preds) > 0 or err > 1e-5):
            raise AssertionError(f"{model}: cuda vs cpu max err {err}, "
                                 f"spread {np.ptp(preds)}")
        totals[0] += launched
        emit({"predict": {"model": model, "batch_size": batch, **report,
                          "max_abs_err_vs_cpu": err, "seed": seed,
                          "predictions_spread": float(np.ptp(preds)),
                          "k1_launches": launched,
                          "seconds_export_and_predict": time.perf_counter() - t0},
              "card": card})

        variants = {model: {}}
        if model == "dcn_v2":
            variants["dcn_v2 sparse"] = {
                "hyper_parameters.sparse_update": True,
                "hyper_parameters.sparse_update_rule": "adagrad",
                "hyper_parameters.sparse_feature_dtype": "bfloat16"}
        for name, extra in variants.items():
            # two epochs over the same 24 batches: the second must read lower
            run_cfg = train_config(cfg, work, batch, **{
                "runner.model_save_path": None, "runner.infer_load_path": None,
                "runner.epochs": 2, **extra})
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            trainer, twin = None, None
            if model in ZOO_HEAD_MAY_DIE:
                # the same run on the CPU from the same parameters: the card's
                # loss need not fall only if the twin's head died as well
                host = Trainer(run_cfg, device="cpu")
                host.init_state(seed=seed)
                trainer = Trainer(run_cfg)
                trainer.init_state(seed=seed)
                trainer.state.module.load_state_dict(host.state.module.state_dict())
                lines = LossLines()
                logger.addHandler(lines)
                try:
                    host.train()
                finally:
                    logger.removeHandler(lines)
                twin = {"logged_losses": lines.losses,
                        "dead_head": dead_head(lines.losses)}
                del host
            alive = twin is None or not twin["dead_head"]
            runs[name] = run_training(gp, run_cfg, seed, trainer=trainer, tables=tables,
                                      min_steps=24, check_fall=alive, check_auc=alive)
            runs[name].update({
                "model": name, "seed": seed,
                "dead_head": dead_head(runs[name]["logged_losses"]),
                "peak_allocated_bytes": torch.cuda.max_memory_allocated() - base})
            if twin is not None:
                runs[name]["cpu_twin"] = twin
                if runs[name]["dead_head"] != twin["dead_head"]:
                    raise AssertionError(f"{name}: the head died on one device only: "
                                         f"{runs[name]['logged_losses']} against {twin}")
            del trainer
            emit({"train": runs[name], "card": card})
            totals[0] += runs[name]["k1_launches"] + runs[name]["eval"]["k1_launches"]
            totals[1] += runs[name]["k1b_launches"]
    return {"k1_launches": totals[0], "k1b_launches": totals[1], "runs": runs}


SEQ = ("din", "dien", "bst", "dsin", "dmr", "dpin")  # the behaviour-sequence models
SEQ_BATCH = 32  # the batch of their configs
SEQ_ROWS = 100 * SEQ_BATCH  # din's and dien's synthetic rows: 100 steps an epoch
SEQ_TWIN_ROWS = 256  # the served rows the CPU run predicts too (rows are independent)
SEQ_SERVE = (SEQ_BATCH, 1024)


def seq_tables(module):
    """The module's ``Embed`` tables counted by row width: each is read once
    per forward (one K1 launch) and trained once per step (one K1b)."""
    import collections

    from paddlerec_tpu_torch.ops.embedding import Embed

    return collections.Counter(m.features for m in module.modules() if isinstance(m, Embed))


def _counts(gp):
    return (gp.gather_pool.launches, gp.gather_pool_bwd.launches,
            dict(gp.gather_pool.launches_by_dim), dict(gp.gather_pool_bwd.launches_by_dim))


def _reset(gp):
    gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
    gp.gather_pool.launches_by_dim.clear()
    gp.gather_pool_bwd.launches_by_dim.clear()


def _add_dims(out: dict, key: str, counts) -> None:
    for d, c in counts.items():
        out[key][d] = out[key].get(d, 0) + c


def _add_launched(out: dict, launched) -> None:
    """Add ``_counts(gp)`` to a phase's totals."""
    out["k1"] += launched[0]
    out["k1b"] += launched[1]
    _add_dims(out, "k1_by_dim", launched[2])
    _add_dims(out, "k1b_by_dim", launched[3])


def _add_run(out: dict, run: dict) -> None:
    """Add a ``run_training`` result's launches to a phase's totals."""
    out["k1"] += run["k1_launches"] + run["eval"]["k1_launches"]
    out["k1b"] += run["k1b_launches"]
    _add_dims(out, "k1_by_dim", run["k1_launches_by_dim"])
    _add_dims(out, "k1b_by_dim", run["k1b_launches_by_dim"])


def _same_noise(model_def, trainer, seed: int) -> None:
    """sign on the card and its CPU twin draw the same gates: uniform noise
    from ``RandomState(seed + step)`` in place of the trainer's generator."""
    def draw(generator, shape, device):
        noise = np.random.RandomState(seed + trainer.state.step).rand(*shape)
        return torch.from_numpy(noise.astype(np.float32)).to(device)

    model_def.draw_noise = draw


# the aux entry a forward is compared on: the predictions, deeprec's
# reconstruction, the positive's similarity or logit of the match models
TWIN_KEYS = ("predictions", "outputs", "sim_pos", "pos_sim", "pos_logit")


def _twin_output(model_def, module, batch) -> np.ndarray:
    """What a forward is compared on: the first of ``TWIN_KEYS`` in the
    aux, bert4rec's logits (its aux holds only 0/1 flags), both of sign's
    clipped outputs (its predictions are the second alone)."""
    with torch.no_grad():
        if model_def.registry_name == "rank.bert4rec":
            return module(*model_def.model_inputs(batch)).cpu().numpy()
        if model_def.registry_name == "rank.sign":
            return module(*model_def.model_inputs(batch))[0].cpu().numpy()
        aux = model_def.infer_forward(module, batch)
    return next(aux[k] for k in TWIN_KEYS if k in aux).cpu().numpy()


def _fill_zero_tables(module, seed: int) -> None:
    """Tables that start at zero (din's item bias, word2vec's output table
    and bias) get a seeded normal(0.1), so that the first forward compares
    more than 0."""
    from paddlerec_tpu_torch.ops.embedding import Embed

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Embed) and not m.embedding.any():
                m.embedding.normal_(0.0, 0.1, generator=g)


def _twin_steps(gp, chip, host, batches, output) -> tuple:
    """A module on the card (``chip``, a trainer) and its twin on the CPU
    (``host``) holding the same parameters: ``output(model_def, module,
    batch)`` on the first batch, then a train step on each of the others, on
    both.  Returns (the comparison, atol ``ZOO_ATOL``; the card's
    ``_counts`` of the forward and of the steps); the twin must launch no
    kernel."""
    from paddlerec_tpu_torch.core.device import to_tensors

    outs, losses, launched = {}, {}, {}
    for device, trainer in (("cuda", chip), ("cpu", host)):
        _reset(gp)
        outs[device] = output(trainer.model_def, trainer.state.module,
                              to_tensors(batches[0], trainer.device))
        forward = _counts(gp)
        _reset(gp)
        ms, losses[device] = trainer._init_metric_state(), []
        for b in batches[1:]:
            ms, loss = trainer.train_step(to_tensors(b, trainer.device), ms)
            losses[device].append(float(loss))
        launched[device] = (forward, _counts(gp))
    if launched["cpu"][0][:2] + launched["cpu"][1][:2] != (0, 0, 0, 0):
        raise AssertionError(f"the CPU twin launched a kernel: {launched['cpu']}")
    out_err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    loss_err = float(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"])).max())
    ok = bool(np.all(np.isfinite(outs["cuda"])) and np.all(np.isfinite(losses["cuda"]))
              and np.ptp(outs["cuda"]) > 0 and len(set(losses["cuda"])) > 1
              and out_err <= ZOO_ATOL and loss_err <= ZOO_ATOL)
    return ({"ok": ok, "atol": ZOO_ATOL, "max_abs_err_outputs": out_err,
             "outputs_spread": float(np.ptp(outs["cuda"])), "max_abs_err_loss": loss_err,
             "loss_cuda": losses["cuda"]}, launched["cuda"])


# the rows of a twin's batch where the CPU side would take most of a phase:
# kim's batch of 32 carries 64 MB of one-hop entity vectors (51 s of phase 23
# at 32 on the CPU)
TWIN_ROWS = {"match.kim": 8}


def twin_zoo(gp, seed: int, card: str, models, name: str, config=None,
             expect_tables=None) -> dict:
    """Phases 13, 16 and 23: each of ``models`` at the full width of its
    config (``config(model)``, by default ``zoo_config``), batch 32
    (``TWIN_ROWS`` where it names the model): a module on the card and its
    twin on the CPU from one seed (tables that start at
    zero filled: ``_fill_zero_tables``), one forward and three train steps on
    four of the model's example batches (a stochastic model's noise the same
    on both); outputs (``_twin_output``) and losses card against CPU (atol
    1e-5); K1 launches per forward = the model's ``Embed`` tables (as many
    as ``expect_tables`` says where it names the model: ``REST_TABLES`` by
    default), K1b launches per step the same, both counted by row width.
    Emits one line under ``name``."""
    from paddlerec_tpu_torch.train.trainer import Trainer

    config = config or zoo_config
    expect_tables = REST_TABLES if expect_tables is None else expect_tables
    results, failed = [], []
    totals = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}}
    for model in models:
        cfg = config(model)
        t0 = time.perf_counter()
        host = Trainer(cfg, device="cpu")
        host.init_state(seed=seed)
        _fill_zero_tables(host.state.module, seed)
        chip = Trainer(cfg)
        chip.init_state(seed=seed)
        chip.state.module.load_state_dict(host.state.module.state_dict())
        widths = seq_tables(chip.state.module)
        tables = sum(widths.values())
        if tables != expect_tables.get(model, tables):
            raise AssertionError(f"{model}: {dict(widths)} tables, "
                                 f"not {expect_tables[model]}")
        if host.stochastic:
            for trainer in (host, chip):
                _same_noise(trainer.model_def, trainer, seed + 16)
        per = TWIN_ROWS.get(model, SEQ_BATCH)
        rows = host.model_def.example_batch(4 * per)
        batches = [{k: v[i * per:(i + 1) * per] for k, v in rows.items()} for i in range(4)]
        twin, launched = _twin_steps(gp, chip, host, batches, _twin_output)
        steps = len(batches) - 1
        per_step = {d: c * steps for d, c in widths.items()}
        (f1, f1b, f1_dim, _), (s1, s1b, s1_dim, s1b_dim) = launched
        if not (f1 == tables and f1b == 0 and f1_dim == dict(widths)
                and s1 == s1b == tables * steps and s1_dim == s1b_dim == per_step):
            raise AssertionError(f"{model}: K1, K1b launches {launched}, "
                                 f"expected {tables} tables {dict(widths)}")
        _add_launched(totals, (f1 + s1, s1b, {}, s1b_dim))
        _add_dims(totals, "k1_by_dim", f1_dim)
        _add_dims(totals, "k1_by_dim", s1_dim)
        results.append({
            "model": model, **twin, "seed": seed, "tables_by_dim": dict(widths),
            "k1_per_forward": f1, "k1b_per_step": s1b // steps,
            "parameters": sum(p.numel() for p in chip.state.module.parameters()),
            "seconds": time.perf_counter() - t0})
        if not twin["ok"]:
            failed.append(model)
        del host, chip
        gc.collect()
        torch.cuda.empty_cache()
    emit({name: results, "batch_size": SEQ_BATCH, "card": card})
    if failed:
        raise AssertionError(f"card and CPU disagree for {failed}")
    return totals


def write_din_data(data_dir: str, rows: int, seed: int, items: int = 63001,
                   cats: int = 801, t: int = 128, files: int = 4) -> None:
    """Rows in ``DINDataset``'s format (``hist_items;hist_cats;item;cat;
    label``) with a planted signal: each row's user has three favourite
    categories, four in five of the history's events come from them, the
    target is an item of one of them half of the time and then clicked with
    probability 0.8, otherwise any item, clicked with probability 0.1."""
    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    item_cat = (np.arange(items) * 7919) % (cats - 1) + 1
    order = np.argsort(item_cat, kind="stable")
    start = np.searchsorted(item_cat[order], np.arange(cats + 1))

    def pick(c):  # an item of each category in c
        return order[start[c] + (rng.rand(len(c)) * (start[c + 1] - start[c])).astype(int)]

    for f in range(files):
        lines = []
        for _ in range(rows // files):
            fav = rng.randint(1, cats, 3)
            n = rng.randint(1, t + 1)
            hist = np.where(rng.rand(n) < 0.8, pick(fav[rng.randint(0, 3, n)]),
                            rng.randint(1, items, n))
            liked = rng.rand() < 0.5
            target = pick(fav[rng.randint(0, 3, 1)])[0] if liked else rng.randint(1, items)
            label = int(rng.rand() < (0.8 if liked else 0.1))
            lines.append(f"{' '.join(map(str, hist))};{' '.join(map(str, item_cat[hist]))};"
                         f"{target};{item_cat[target]};{label}")
        with open(os.path.join(data_dir, f"part-{f}"), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def write_dmr_data(data_dir: str, rows: int, seed: int, cfg) -> None:
    """Rows in ``DMRDataset``'s format at the full width of ``cfg``: 5·T
    history columns (btag, cate, brand, mask, match_mask; histories
    right-aligned), 16 ids, the price at column 5·T + 14, the label last,
    clicked with probability 0.6 where the target category is in the history
    and 0.2 elsewhere."""
    from paddlerec_tpu_torch.core.registry import load_model_def

    model_def = load_model_def(cfg)
    v, t = model_def.vocab, model_def.history_length
    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        n = rng.randint(1, t + 1)
        mask = (np.arange(t) >= t - n).astype(int)
        cate = rng.randint(0, v["cate"], t)
        cols = [rng.randint(0, v["btag"], t), cate, rng.randint(0, v["brand"], t), mask, mask]
        target_cate = cate[-1] if rng.rand() < 0.5 else rng.randint(0, v["cate"])
        scalars = [rng.randint(0, v["user"])]
        scalars += [rng.randint(0, v[name]) for name in (
            "cms_segid", "cms_group_id", "final_gender_code", "age_level", "pvalue_level",
            "shopping_level", "occupation", "new_user_class_level")]
        scalars += [rng.randint(0, v["adgroup_id"]), target_cate,
                    rng.randint(0, v["campaign_id"]), rng.randint(0, v["customer"]),
                    rng.randint(0, v["brand"])]
        clicked = rng.rand() < (0.6 if target_cate in cate[t - n:] else 0.2)
        vals = [str(x) for c in cols for x in c] + [str(x) for x in scalars]
        vals += [f"{rng.rand():.6f}", str(rng.randint(0, v["pid"])), str(int(clicked))]
        lines.append(",".join(vals))
    with open(os.path.join(data_dir, "part-0"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def seq_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 14: din and dien at the full width of their configs through the
    entry points, on rows in ``DINDataset``'s format written from ``seed``:
    ``Trainer.train()`` for two epochs at the config's batch 32 (a checkpoint
    each), the last logged loss below the first and the second epoch's mean
    below the first's, ``evaluate()`` from the checkpoint, one K1 launch per
    table and forward, one K1b per table and step; ``export_model`` of the
    checkpoint and ``run_predict`` at batch 32 and 1024 against the port's CPU
    run of the artifact on the first ``SEQ_TWIN_ROWS`` rows (atol 1e-5), with
    p50/p99; ``torch.profiler`` over
    the din and dien train step.  Then dmr through ``tools.train`` on rows in
    its own format."""
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.tools import train as train_cli
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict

    data = os.path.join(work, "din_data")
    write_din_data(data, SEQ_ROWS, seed + 14)
    # the CPU run predicts the first rows only: a row's prediction does not
    # depend on the others in its batch (histories padded to a static length)
    twin = f"{data}_head"
    with open(os.path.join(data, "part-0")) as fh:
        _write_lines(twin, [fh.readline().rstrip("\n") for _ in range(SEQ_TWIN_ROWS)])
    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}, "runs": {}}

    for model in ("din", "dien"):
        ckpt = os.path.join(work, f"ckpt_{model}")
        run_cfg = Config({**zoo_config(model).to_dict(),
                          "runner.train_data_dir": data, "runner.test_data_dir": data,
                          "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
                          "runner.epochs": 2, "runner.print_interval": 25})
        tables = sum(seq_tables(load_model_def(run_cfg).make_module(device="meta")).values())
        run = run_training(gp, run_cfg, seed, tables=tables,
                           min_steps=2 * SEQ_ROWS // SEQ_BATCH)
        losses = run["logged_losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{model}: the last logged loss is not below the first: "
                                 f"{losses}")
        run["model"] = model
        _add_run(out, run)
        out["runs"][model] = run
        emit({"train": run, "card": card})

        export_dir = os.path.join(work, f"export_{model}")
        t0 = time.perf_counter()
        export_model(Config({**run_cfg.to_dict(),
                             "runner.model_init_path": os.path.join(ckpt, "1")}), export_dir)
        shutil.rmtree(ckpt)
        cpu_preds = np.concatenate(run_predict(export_dir, twin, SEQ_SERVE[-1], device="cpu")[0])
        for batch in SEQ_SERVE:
            _reset(gp)
            served, report = run_predict(export_dir, data, batch)
            launched = gp.gather_pool.launches
            preds = np.concatenate(served)
            err = float(np.abs(preds[:SEQ_TWIN_ROWS] - cpu_preds).max())
            if launched != tables * math.ceil(SEQ_ROWS / batch):
                raise AssertionError(f"{model}: {launched} K1 launches at batch {batch}")
            if preds.shape != (SEQ_ROWS,) or not np.ptp(preds) > 0 or err > ZOO_ATOL:
                raise AssertionError(f"{model}: served predictions, card vs CPU max err {err}")
            out["k1"] += launched
            _add_dims(out, "k1_by_dim", gp.gather_pool.launches_by_dim)
            emit({"predict": {"model": model, "batch_size": batch, **report,
                              "max_abs_err_vs_cpu": err, "k1_launches": launched,
                              "seconds_export_and_predict": time.perf_counter() - t0},
                  "card": card})
        shutil.rmtree(export_dir)
        # dien's step launches thousands of kernels: the profiler's own
        # bookkeeping (parsing its events on the host) grows with them, so it
        # profiles fewer
        emit({"profile_train": profile_train(run_cfg, SEQ_BATCH, seed,
                                             iters=5 if model == "din" else 2),
              "card": card})

    # dmr through the train CLI, on rows in its own format
    cfg = zoo_config("dmr")
    dmr_data = os.path.join(work, "dmr_data")
    write_dmr_data(dmr_data, 40 * SEQ_BATCH, seed + 15, cfg)
    tables = sum(seq_tables(load_model_def(cfg).make_module(device="meta")).values())
    _reset(gp)
    t0 = time.perf_counter()
    metrics = train_cli.main([
        "-m", os.path.join(ROOT, "configs", "rank", "dmr", "config.yaml"), "-o",
        f"runner.train_data_dir={dmr_data}", f"runner.test_data_dir={dmr_data}",
        "runner.model_save_path=None", "runner.print_interval=10"])
    steps = 40
    launched = _counts(gp)
    if launched[:2] != (tables * steps, tables * steps) or not np.isfinite(metrics["auc"]):
        raise AssertionError(f"dmr through tools.train: K1, K1b {launched[:2]}, {metrics}")
    _add_launched(out, launched)
    emit({"train_cli": {"model": "dmr", "steps": steps, "batch_size": SEQ_BATCH,
                        "seconds": time.perf_counter() - t0, "auc": metrics["auc"],
                        "examples_per_s": metrics["ips"], "k1_launches": launched[0],
                        "k1b_launches": launched[1], "tables": tables}, "card": card})
    return out


REST = ("deeprec", "iprec", "naml", "fastformer", "sign", "bert4rec")  # the rest of the rank family
# K1 launches per forward and K1b per step: one per Embed table
REST_TABLES = {"deeprec": 0, "iprec": 3, "naml": 3, "fastformer": 5, "sign": 2, "bert4rec": 3}
REST_SERVED = ("iprec", "naml", "fastformer")
REST_SERVE_TIMED = 4  # the timed batches of 1024 served after the warm-up
REST_SERVE_ROWS = (REST_SERVE_TIMED + 1) * 1024 + 64
REST_TWIN_ROWS = 256  # the served rows the CPU twin predicts too (rows are independent)
REST_TRAIN_ROWS = 60 * SEQ_BATCH  # naml's and bert4rec's rows: 60 steps an epoch
CHAIN_ITEMS = 200  # bert4rec's Markov chain
# the four models driven through tools.train: two epochs of 60 steps, the
# second timed
REST_CLI_ROWS = 60 * SEQ_BATCH


def _write_lines(data_dir: str, lines) -> None:
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "part-0"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_news_data(data_dir: str, rows: int, seed: int, md) -> None:
    """Rows in ``NewsDataset``'s format at the widths of ``md`` with a planted
    signal: a user browses news of one favourite category; the positive
    candidate shares it, the negatives come from the other categories; each
    news' title and content words are drawn mostly from its category's
    own tenth of the vocabulary."""
    rng = np.random.RandomState(seed)
    s, v = md.neg_size + 1, md.browse_size
    cats, words = md.category_size, md.word_dict_size
    band = words // 10

    def text(c, length):  # words of news of categories c, 70% from their band
        own = (c[:, None] * band + rng.randint(0, band, (len(c), length))) % words
        return np.where(rng.rand(len(c), length) < 0.7, own,
                        rng.randint(0, words, (len(c), length)))

    def news(c):  # (cate, sub_cate, title, content) of news of categories c
        return (c, (c * 2 + rng.randint(0, 2, len(c))) % (md.sub_category_size + 1),
                text(c, md.title_size), text(c, md.content_size))

    lines = []
    for _ in range(rows):
        fav = rng.randint(1, cats + 1)
        others = np.array([c for c in range(1, cats + 1) if c != fav])
        pos = rng.randint(0, s)
        cand = others[rng.randint(0, len(others), s)]
        cand[pos] = fav
        labels = np.zeros(s, int)
        labels[pos] = 1
        sample, visit = news(cand), news(np.full(v, fav))
        groups = [labels] + [g for pair in zip(sample, visit) for g in pair]
        lines.append(";".join(",".join(map(str, g.reshape(-1))) for g in groups))
    _write_lines(data_dir, lines)


def write_bert4rec_data(data_dir: str, rows: int, seed: int, items: int = CHAIN_ITEMS) -> None:
    """``uid item...`` sequences of 10 to 50 items from a Markov chain over
    ``items`` items that starts at item 1: the next item is ``(7·i + 3) %
    items + 1`` nine times in ten, else any item.  The fixed start ties
    early positions to items, which bert4rec learns within an epoch; from a
    random start it can sit at the unigram loss (ln ``items``) for thousands
    of steps before it learns the transitions."""
    rng = np.random.RandomState(seed)
    lines = []
    for u in range(rows):
        seq = [1]
        for _ in range(rng.randint(10, 51) - 1):
            seq.append((7 * seq[-1] + 3) % items + 1 if rng.rand() < 0.9
                       else rng.randint(1, items + 1))
        lines.append(" ".join(map(str, [u] + seq)))
    _write_lines(data_dir, lines)


def write_deeprec_data(data_dir: str, rows: int, seed: int, n_items: int) -> None:
    """``idx:rating`` lines, 20 to 200 ratings a user."""
    rng = np.random.RandomState(seed)
    _write_lines(data_dir, [
        " ".join(f"{i}:{rng.randint(1, 6)}"
                 for i in rng.choice(n_items, rng.randint(20, 201), replace=False))
        for _ in range(rows)])


def write_iprec_data(data_dir: str, rows: int, seed: int, md) -> None:
    """JSON lines at the widths of ``md``: each list filled to a random
    length up to its maximum, packages of ``[item, biz, friends...]``."""
    rng = np.random.RandomState(seed)
    w = md.f_max_len + 2

    def ids(hi, most):
        return rng.randint(1, hi, rng.randint(1, most + 1)).tolist()

    def packs(most):
        n = rng.randint(0, most + 1)
        out = np.zeros((n, w), np.int64)
        out[:, 0] = rng.randint(1, md.num_items, n)
        out[:, 1] = rng.randint(1, md.num_bizs, n)
        out[:, 2:] = rng.randint(1, md.num_users, (n, w - 2)) * (rng.rand(n, w - 2) < 0.6)
        return out.reshape(-1).tolist()

    lines = []
    for _ in range(rows):
        lines.append(json.dumps({
            "user": int(rng.randint(1, md.num_users)), "item": int(rng.randint(1, md.num_items)),
            "biz": int(rng.randint(1, md.num_bizs)), "friends": ids(md.num_users, md.f_max_len),
            "user_items": ids(md.num_items, md.u_max_i), "user_bizs": ids(md.num_bizs, md.u_max_i),
            "user_friends": ids(md.num_users, md.u_max_f),
            "user_packages": packs(md.u_max_pack), "pack_neighbors_b": packs(md.pack_max_nei_b),
            "pack_neighbors_f": packs(md.pack_max_nei_f),
            "label1": int(rng.rand() < 0.3), "label2": 0}))
    _write_lines(data_dir, lines)


def write_sign_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``label feat...`` lines of ``num_nodes`` features."""
    rng = np.random.RandomState(seed)
    _write_lines(data_dir, [
        " ".join(map(str, [int(rng.rand() < 0.5)]
                 + rng.randint(0, md.n_feature, md.num_nodes).tolist()))
        for _ in range(rows)])


def rank_rest_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 17, the rest of the rank family through the entry points at the
    full width of their configs, batch 32:
      * naml (planted signal: the positive shares the browsed category) and
        bert4rec (Markov-chain sequences): ``Trainer.train()`` for two
        epochs of 60 steps, the loss falling, ``evaluate()`` reporting AUC
        above 0.5 / an accuracy above five times chance;
      * deeprec, iprec, fastformer and sign: ``tools.train`` for two epochs
        of 60 steps each on rows in their format, every logged loss
        finite, the second epoch's examples/s;
      * iprec, naml and fastformer served: ``export_model`` (naml from its
        checkpoint, the others from a seed) and ``run_predict`` at batch 32
        and 1024, the first 512 rows against the port's CPU run (atol
        1e-5), with p50/p99;
      * ``torch.profiler`` over the iprec and fastformer train step.
    K1 and K1b launches are asserted per table, forward and step."""
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.tools import train as train_cli
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.trainer import logger

    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}, "runs": {}}
    defs = {m: load_model_def(zoo_config(m)) for m in REST}
    writers = {
        "naml": lambda d, n, s: write_news_data(d, n, s, defs["naml"]),
        "fastformer": lambda d, n, s: write_news_data(d, n, s, defs["fastformer"]),
        "bert4rec": lambda d, n, s: write_bert4rec_data(d, n, s),
        "deeprec": lambda d, n, s: write_deeprec_data(d, n, s, defs["deeprec"].layer_sizes[0]),
        "iprec": lambda d, n, s: write_iprec_data(d, n, s, defs["iprec"]),
        "sign": lambda d, n, s: write_sign_data(d, n, s, defs["sign"]),
    }
    naml_ckpt = os.path.join(work, "ckpt_naml")
    for i, model in enumerate(("naml", "bert4rec")):
        data = os.path.join(work, f"{model}_data")
        writers[model](data, REST_TRAIN_ROWS, seed + 17 + i)
        # naml is served from its checkpoint; bert4rec saves none
        ckpt = naml_ckpt if model == "naml" else None
        run_cfg = Config({**zoo_config(model).to_dict(),
                          "runner.train_data_dir": data, "runner.test_data_dir": data,
                          "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
                          "runner.epochs": 2, "runner.print_interval": 20})
        run = run_training(gp, run_cfg, seed, tables=REST_TABLES[model],
                           min_steps=2 * REST_TRAIN_ROWS // SEQ_BATCH)
        losses = run["logged_losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{model}: the last logged loss is not below the first: "
                                 f"{losses}")
        if model == "bert4rec" and not run["eval"]["acc"] > 5 / CHAIN_ITEMS:
            raise AssertionError(f"bert4rec did not learn the chain: {run['eval']}")
        run["model"] = model
        _add_run(out, run)
        out["runs"][model] = run
        emit({"train": run, "card": card})

    for model in ("deeprec", "iprec", "fastformer", "sign"):
        data = os.path.join(work, f"{model}_cli")
        writers[model](data, REST_CLI_ROWS, seed + 18)
        lines = LossLines()
        logger.addHandler(lines)
        _reset(gp)
        t0 = time.perf_counter()
        try:
            metrics = train_cli.main([
                "-m", os.path.join(ROOT, "configs", "rank", model, "config.yaml"), "-o",
                f"runner.train_data_dir={data}", f"runner.test_data_dir={data}",
                "runner.model_save_path=None", "runner.epochs=2",
                "runner.print_interval=20"])
        finally:
            logger.removeHandler(lines)
        steps = 2 * REST_CLI_ROWS // SEQ_BATCH
        launched = _counts(gp)
        tables = REST_TABLES[model]
        if (launched[:2] != (tables * steps, tables * steps) or len(lines.losses) < 4
                or not np.all(np.isfinite(lines.losses))):
            raise AssertionError(f"{model} through tools.train: K1, K1b {launched[:2]}, "
                                 f"losses {lines.losses}")
        _add_launched(out, launched)
        emit({"train_cli": {"model": model, "steps": steps, "batch_size": SEQ_BATCH,
                            "seconds": time.perf_counter() - t0,
                            "logged_losses": lines.losses,
                            "last_epoch_examples_per_s": metrics["ips"],
                            "k1_launches": launched[0], "k1b_launches": launched[1],
                            "tables": tables}, "card": card})

    for model in REST_SERVED:
        data = os.path.join(work, f"{model}_serve")
        writers[model](data, REST_SERVE_ROWS, seed + 19)
        export_dir = os.path.join(work, f"export_{model}")
        flat = zoo_config(model).to_dict()
        t0 = time.perf_counter()
        if model == "naml":
            flat["runner.model_init_path"] = os.path.join(naml_ckpt, "1")
        export_model(Config(flat), export_dir, seed=seed)
        # the CPU twin predicts the first rows only: a row's prediction does
        # not depend on the others in its batch.  A news model scores 1 + 4
        # candidates a row, and its padded tail rows too (the mask is per
        # row): keep the real rows' scores
        twin = f"{data}_head"
        with open(os.path.join(data, "part-0")) as fh:
            _write_lines(twin, [fh.readline().rstrip("\n") for _ in range(REST_TWIN_ROWS)])
        keep = REST_TWIN_ROWS * (defs[model].neg_size + 1 if model != "iprec" else 1)
        cpu_preds = np.concatenate(
            run_predict(export_dir, twin, REST_TWIN_ROWS // 2, device="cpu")[0])[:keep]
        tables = REST_TABLES[model]
        for batch in SEQ_SERVE:
            _reset(gp)
            served, report = run_predict(export_dir, data, batch)
            launched = gp.gather_pool.launches
            preds = np.concatenate(served)[:keep]
            err = float(np.abs(preds - cpu_preds).max())
            if launched != tables * math.ceil(REST_SERVE_ROWS / batch):
                raise AssertionError(f"{model}: {launched} K1 launches at batch {batch}")
            if (preds.shape != cpu_preds.shape or not np.ptp(preds) > 0
                    or not np.all(np.isfinite(preds)) or err > ZOO_ATOL):
                raise AssertionError(f"{model}: served predictions, card vs CPU max err {err}")
            out["k1"] += launched
            _add_dims(out, "k1_by_dim", gp.gather_pool.launches_by_dim)
            emit({"predict": {"model": model, "batch_size": batch, "rows": REST_SERVE_ROWS,
                              **report, "max_abs_err_vs_cpu": err, "k1_launches": launched,
                              "seconds_export_and_predict": time.perf_counter() - t0},
                  "card": card})
        shutil.rmtree(export_dir)
        gc.collect()
        torch.cuda.empty_cache()
    # hundreds of kernels a step: 5 steps keep the profiler's events few
    for model in ("iprec", "fastformer"):
        emit({"profile_train": profile_train(zoo_config(model), SEQ_BATCH, seed, iters=5),
              "card": card})
    return out


# the rest of the rank family's lookups at batch 32, one K1 launch each (fill
# mode), as SEQ_SHAPES
REST_SHAPES = (
    ("naml/fastformer word2vec_embedding, title + content", 102, 30, 32 * 15 * 40, "uniform"),
    ("bert4rec sent_embedding, every id 0", 2, 64, 32 * 50, "zeros"),
    ("bert4rec word_embedding", 54546, 64, 32 * 50, "uniform"),
    ("bert4rec pos_embedding", 50, 64, 32 * 50, "period 50"),
    ("fastformer title position_emb", 256, 400, 32 * 15 * 10, "period 10"),
    ("fastformer content position_emb", 256, 400, 32 * 15 * 30, "period 30"),
    # user, friends, and the friends of 1 + 50 + 20 + 20 packages
    ("iprec user_emb, three lookups in one", 554238, 64, 32 + 32 * 220 + 32 * 91 * 20,
     "uniform"),
)


@_uncounted
def check_fill_shapes(gp, seed: int, card: str, shapes) -> None:
    """Phase 18, before the timing: K1 and K1b at each of ``shapes`` against
    their plain versions: K1 bitwise (a gather); K1b rtol 1e-5 and atol 1e-6
    times the most adds any row takes, since atomics add in another order
    and a reordered float32 sum's rounding grows with its terms (1e-6 where
    rows take one add)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for name, rows, dim, n, kind in shapes:
        table = torch.randn(rows, dim, device="cuda", generator=g)
        ids = _fill_ids(kind, rows, n, g)
        grad = torch.randn(n, dim, device="cuda", generator=g)
        adds = int(torch.bincount(ids.reshape(-1).long()).max())
        out = gp.gather_pool(table, ids, mode="fill")
        ref = gp.gather_pool_plain(table, ids, mode="fill")
        dt = gp.gather_pool_bwd(grad, ids, None, rows, mode="fill")
        dt_ref = gp.gather_pool_bwd_plain(grad, ids, None, rows, mode="fill")
        torch.cuda.synchronize()
        atol = 1e-6 * adds
        check = {"shape": name, "n": n, "dim": dim, "rows": rows, "most_adds_per_row": adds,
                 "k1_bitwise": bool(torch.equal(out, ref)),
                 "k1b_max_abs_err": float((dt - dt_ref).abs().max()),
                 "k1b_tolerance": {"rtol": 1e-5, "atol": atol},
                 "k1b_ok": bool(torch.allclose(dt, dt_ref, rtol=1e-5, atol=atol))}
        checks.append(check)
        if not (check["k1_bitwise"] and check["k1b_ok"]):
            raise AssertionError(f"a kernel disagrees with its plain version: {check}")
        del table, ids, grad, out, ref, dt, dt_ref
    emit({"rank_rest_kernel_checks": checks, "card": card})


# -- the multitask family (phases 19-22) ---------------------------------------
MULTITASK = ("share_bottom", "mmoe", "ple", "esmm", "aitm", "escm2", "dselect_k", "maml",
             "metaheac")
ALI_CCP_MODELS = ("esmm", "aitm", "escm2")
MT_TRAIN_STEPS = 80  # steps an epoch at the configs' batch 32
MT_EPISODES = 20  # maml's episodes an epoch (each a batch of 32 tasks)
MT_SERVE_ROWS = REST_SERVE_ROWS  # REST_SERVE_TIMED timed batches of 1024 after the warm-up
MT_SERVE_BATCHES = REST_SERVE_TIMED + 1  # metaheac's served batches: a warm-up, then timed


def mt_config(model: str, **extra):
    from paddlerec_tpu_torch.core.config import Config, load_config

    cfg = load_config(os.path.join(ROOT, "configs", "multitask", model, "config.yaml"))
    return Config({**cfg.to_dict(), **extra}) if extra else cfg


def mt_launches(model_def) -> tuple:
    """(K1, K1b) launches of one inference forward and of one train step.
    esmm, aitm, escm2: their one table, read once and trained once.
    metaheac: for each task, its n tables read by the support and the query
    and the support's inner gradient; a train step keeps that gradient's
    graph, and its backward runs K1b for the query, K1 as the backward of
    the inner K1b, and K1b back through the support's lookup.  The other
    models have no table."""
    name = model_def.registry_name.split(".")[1]
    if name in ALI_CCP_MODELS:
        return (1, 0), (1, 1)
    if name == "metaheac":
        n = model_def.task_count * (len(model_def.static_vocabs) + len(model_def.dynamic_vocabs)
                                    + len(model_def.ad_vocabs))
        return (2 * n, n), (3 * n, 3 * n)
    return (0, 0), (0, 0)


def _split_batch(batch: dict, parts: int, axis: int) -> list:
    size = next(iter(batch.values())).shape[axis] // parts
    return [{k: np.take(v, range(i * size, (i + 1) * size), axis=axis)
             for k, v in batch.items()} for i in range(parts)]


def _mt_output(model_def, module, batch) -> np.ndarray:
    """What a forward is compared on: every probability of the aux
    (inference forward: metaheac's after its inner step), maml's meta-loss
    after its inner loop (its aux holds only 0/1 flags)."""
    with model_def.infer_context():
        if model_def.registry_name == "multitask.maml":
            return np.array([float(model_def.train_forward(module, batch)[0].detach())])
        aux = model_def.infer_forward(module, batch)
    return np.concatenate([aux[k].detach().float().cpu().numpy().reshape(-1)
                           for k in ("probs", "ctr", "cvr", "ctcvr", "predictions") if k in aux])


# maml's meta-loss after five inner SGD steps at lr 0.1, on example batches of
# random images with random labels, is ill-conditioned in float32: the same
# batch's meta-loss read 3.4632785 and 3.4632912 on the card in two contexts
# (the convolution algorithm cuDNN picks) and 3.4632778 on the CPU.  And
# Adam's first step moves every weight by ±lr whatever its gradient's size,
# so the entries whose near-zero gradient has opposite signs on the two
# devices step apart, and the inner loop amplifies that: 9e-5 of meta-loss
# after three float64 steps, 0.032 after one float32 step.  So each of
# maml's steps starts from the twin's parameters and Adam state, and maml is
# held in float64 at ``ZOO_ATOL`` (the two devices agree there within
# 1e-15) and in float32 at ``MT_F32_ATOL``, two orders of magnitude above
# the 7e-5 that its conditioning gives.
MT_FLOAT64 = ("maml",)
MT_F32_ATOL = 1e-3
# maml's twin batches: 8 tasks (its CPU side took 62 of phase 19's 74 s at
# the config's 32); the training runs of phase 20 keep 32
MT_TWIN_TASKS = 8


def _mt_twin(gp, model: str, seed: int, dtype=torch.float32, resync: bool = False,
             steps: int = 3):
    """One forward and ``steps`` train steps of ``model`` on the card and on a
    CPU twin from one seed (``dtype``: the parameters' and the batches' float
    type; ``resync``: each step starts from the twin's parameters and Adam
    state).  Returns the outputs, the losses and the launches by device."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer, _copy_into

    cfg = mt_config(model)
    trainers = {"cuda": Trainer(cfg), "cpu": Trainer(cfg, device="cpu")}
    for trainer in trainers.values():
        trainer.init_state(seed=seed)
        if dtype != torch.float32:
            trainer.state.module.to(dtype)
            trainer.state.opt_state = trainer.tx.init(trainer.state.params)
    chip, host = trainers["cuda"], trainers["cpu"]
    chip.state.module.load_state_dict(host.state.module.state_dict())
    per = MT_TWIN_TASKS if model == "maml" else SEQ_BATCH
    batches = _split_batch(host.model_def.example_batch((steps + 1) * per), steps + 1,
                           axis=1 if model == "metaheac" else 0)

    def tensors(batch, device):
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in to_tensors(batch, device).items()}

    outs, losses = {}, {"cuda": [], "cpu": []}
    launched = {d: {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}} for d in trainers}
    for device, trainer in trainers.items():
        _reset(gp)
        outs[device] = _mt_output(trainer.model_def, trainer.state.module,
                                  tensors(batches[0], trainer.device))
        _add_launched(launched[device], _counts(gp))
    forward = (launched["cuda"]["k1"], launched["cuda"]["k1b"])
    ms = {d: t._init_metric_state() for d, t in trainers.items()}
    for b in batches[1:]:
        if resync:
            chip.state.module.load_state_dict(host.state.module.state_dict())
            _copy_into(chip.state.opt_state, host.state.opt_state, "opt_state")
        for device, trainer in trainers.items():
            _reset(gp)
            ms[device], loss = trainer.train_step(tensors(b, trainer.device), ms[device])
            losses[device].append(float(loss))
            _add_launched(launched[device], _counts(gp))
    params = sum(p.numel() for p in chip.state.module.parameters())
    return outs, losses, launched, forward, len(batches) - 1, host.model_def, params


def multitask_zoo(gp, seed: int, card: str) -> dict:
    """Phase 19: each multitask model at the ModelDef's default widths from
    its ``configs/multitask/<model>/config.yaml``, batch 32 (``MT_TWIN_TASKS`` for
    maml, 5 tasks of 32 rows for metaheac): a module on the card and its twin
    on the CPU from one seed, one inference forward and three train steps on
    four of the model's example batches (``_mt_twin``); outputs
    (``_mt_output``) and losses card against CPU, atol 1e-5 (maml's and
    metaheac's losses are their meta-losses after the inner loop; maml in
    float64 over one step, and in float32 at ``MT_F32_ATOL``: see
    ``MT_FLOAT64``); K1 and
    K1b launches per forward and per step as ``mt_launches`` says, none on
    the CPU."""
    results, failed = [], []
    totals = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}}
    for model in MULTITASK:
        runs = [(torch.float32, ZOO_ATOL, False, 3)]
        if model in MT_FLOAT64:
            # the float64 twin (the CPU's float64 convolutions take ~15 s a
            # step at this width) takes one step
            runs = [(torch.float64, ZOO_ATOL, True, 1), (torch.float32, MT_F32_ATOL, True, 3)]
        for dtype, atol, resync, steps in runs:
            t0 = time.perf_counter()
            outs, losses, launched, forward, steps, md, params = _mt_twin(
                gp, model, seed, dtype, resync, steps)
            (fwd_k1, fwd_k1b), (step_k1, step_k1b) = mt_launches(md)
            on_card = launched["cuda"]
            counted = (forward == (fwd_k1, fwd_k1b)
                       and (on_card["k1"], on_card["k1b"]) == (fwd_k1 + step_k1 * steps,
                                                               fwd_k1b + step_k1b * steps))
            if not counted or (launched["cpu"]["k1"], launched["cpu"]["k1b"]) != (0, 0):
                raise AssertionError(f"{model}: K1, K1b launches {launched}, expected "
                                     f"{(fwd_k1, fwd_k1b)} a forward, "
                                     f"{(step_k1, step_k1b)} a step")
            _add_launched(totals, (on_card["k1"], on_card["k1b"], on_card["k1_by_dim"],
                                   on_card["k1b_by_dim"]))
            out_err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
            loss_err = float(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"])).max())
            spread = float(np.ptp(outs["cuda"])) if outs["cuda"].size > 1 else 1.0
            ok = bool(np.all(np.isfinite(outs["cuda"])) and np.all(np.isfinite(losses["cuda"]))
                      and spread > 0 and (steps == 1 or len(set(losses["cuda"])) > 1)
                      and out_err <= atol and loss_err <= atol)
            results.append({
                "model": model, "dtype": str(dtype), "ok": ok, "atol": atol, "seed": seed,
                "max_abs_err_outputs": out_err, "outputs_spread": spread,
                "max_abs_err_loss": loss_err, "loss_cuda": losses["cuda"],
                "loss_cpu": losses["cpu"], "steps_from_the_twin_state": resync,
                "k1_per_forward": forward[0], "k1b_per_forward": forward[1],
                "k1_per_step": (on_card["k1"] - forward[0]) // steps,
                "k1b_per_step": (on_card["k1b"] - forward[1]) // steps,
                "parameters": params, "seconds": time.perf_counter() - t0})
            if not ok:
                failed.append(f"{model} {dtype}")
            gc.collect()
            torch.cuda.empty_cache()
    emit({"multitask_zoo": results, "batch_size": SEQ_BATCH, "card": card})
    if failed:
        raise AssertionError(f"card and CPU disagree for {failed}")
    return totals


def write_census_data(data_dir: str, rows: int, seed: int) -> None:
    """Census CSV rows (marital, income, 499 features), the features 0/1
    indicators as the census' one-hot columns are (about 40 set a row);
    the labels follow a few of them: income that one of features 0-9 is
    set, marital that two of features 10-29 are, each flipped for a tenth
    of the rows."""
    rng = np.random.RandomState(seed)
    feats = (rng.rand(rows, 499) < 0.08).astype(np.float32)
    flip = rng.rand(rows, 2) < 0.1
    income = (feats[:, :10].sum(1) > 0) ^ flip[:, 0]
    marital = (feats[:, 10:30].sum(1) >= 2) ^ flip[:, 1]
    table = np.concatenate([marital[:, None], income[:, None], feats], axis=1)
    os.makedirs(data_dir, exist_ok=True)
    np.savetxt(os.path.join(data_dir, "part-0"), table, fmt="%d", delimiter=",")


def write_aliccp_data(data_dir: str, rows: int, seed: int) -> None:
    """Ali-CCP lines over the 23 fields, 1 to 3 ids a field from a pool of
    50 raw ids per field (spread over 3× the vocabulary, so they are hashed);
    the click follows the first id of field 101 (ids of the pool's first
    half click with probability 0.8, the rest 0.2), the conversion of a
    click the first id of field 205 the same way."""
    from paddlerec_tpu_torch.models.multitask.base import ALI_CCP_FIELDS

    rng = np.random.RandomState(seed)
    pools = rng.randint(0, 3 * 737946, (len(ALI_CCP_FIELDS), 50))
    lines = []
    for i in range(rows):
        picks = [rng.randint(0, 50, rng.randint(1, 4)) for _ in ALI_CCP_FIELDS]
        click = rng.rand() < (0.8 if picks[0][0] < 25 else 0.2)
        conv = click and rng.rand() < (0.8 if picks[ALI_CCP_FIELDS.index("205")][0] < 25
                                       else 0.2)
        feats = [f"{f}:{pools[j, p]}" for j, f in enumerate(ALI_CCP_FIELDS) for p in picks[j]]
        lines.append(",".join([str(i), str(int(click)), str(int(conv)), "0"] + feats))
    _write_lines(data_dir, lines)


def write_multimnist_data(data_dir: str, rows: int, seed: int) -> None:
    """MultiMNIST pickles: a 36×36 image is the left digit's fixed template
    (a random pattern per class) in its left half and the right digit's in
    its right half, plus noise; labels (left, right)."""
    import pickle

    rng = np.random.RandomState(seed)
    templates = rng.rand(2, 10, 36, 18) < 0.3
    y = rng.randint(0, 10, (rows, 2))
    img = np.concatenate([templates[0][y[:, 0]], templates[1][y[:, 1]]], axis=2) * 0.7
    img = np.clip(img + rng.rand(rows, 36, 36) * 0.3, 0, 1)
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "part-0.pickle"), "wb") as f:
        pickle.dump(((img * 255).astype(np.uint8).reshape(rows, -1), y), f)


def write_omniglot_data(data_dir: str, chars: int, seed: int, per_char: int = 20) -> None:
    """An Omniglot tree of 28×28 ``.npy`` images: each character a fixed
    random template plus noise."""
    rng = np.random.RandomState(seed)
    for c in range(chars):
        sub = os.path.join(data_dir, f"alphabet_{c // 10}", f"character{c:02d}")
        os.makedirs(sub)
        template = (rng.rand(28, 28) < 0.3) * 0.7
        for j in range(per_char):
            img = np.clip(template + rng.rand(28, 28) * 0.3, 0, 1).astype(np.float32)
            np.save(os.path.join(sub, f"{j:02d}.npy"), img)


def write_lookalike_data(data_dir: str, rows: int, seed: int, md) -> None:
    """Lookalike rows as a pickled ``np.ndarray``: label, aid, 7 static, 50
    dynamic ids, 7 lengths, 6 ad fields within ``max_idxs``; the label
    follows the first ad field (ids in its lower half click with
    probability 0.9, the rest 0.1)."""
    import pickle

    rng = np.random.RandomState(seed)
    spans = [(hi - lo) for lo, hi in ((0, 10), (10, 20), (20, 30), (30, 35), (35, 40),
                                      (40, 45), (45, 50))]
    ad = np.stack([rng.randint(0, v + 1, rows) for v in md.ad_vocabs], -1)
    label = rng.rand(rows) < np.where(ad[:, 0] <= md.ad_vocabs[0] // 2, 0.9, 0.1)
    cols = [label[:, None], (np.arange(rows) // (2 * SEQ_BATCH))[:, None],
            np.stack([rng.randint(0, v + 1, rows) for v in md.static_vocabs], -1),
            np.concatenate([rng.randint(1, v + 1, (rows, w))
                            for v, w in zip(md.dynamic_vocabs, spans)], -1),
            np.stack([rng.randint(1, w + 1, rows) for w in spans], -1), ad]
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "train.pkl"), "wb") as f:
        pickle.dump(np.concatenate(cols, -1).astype(np.int64), f)


def _mt_data(model: str, data_dir: str, rows: int, seed: int, md) -> None:
    if model in ("share_bottom", "mmoe", "ple"):
        write_census_data(data_dir, rows, seed)
    elif model in ALI_CCP_MODELS:
        write_aliccp_data(data_dir, rows, seed)
    elif model == "dselect_k":
        write_multimnist_data(data_dir, rows, seed)
    elif model == "maml":
        write_omniglot_data(data_dir, 50, seed)
    else:
        write_lookalike_data(data_dir, rows, seed, md)


def _mt_rows(model: str, md) -> int:
    """Rows of one epoch: ``MT_TRAIN_STEPS`` batches of 32 (metaheac: a
    quarter as many steps, each of 5 tasks of 32 support and 32 query rows)."""
    if model == "metaheac":
        return MT_TRAIN_STEPS // 4 * 2 * SEQ_BATCH * md.task_count
    return MT_TRAIN_STEPS * SEQ_BATCH


def multitask_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 20, the multitask family through the entry points at the
    ModelDefs' default widths, batch 32, on rows written in each reader's
    format with a planted signal (``write_*_data``):
      * every model: ``Trainer.train()`` for two epochs (80 steps each;
        metaheac 20 steps of 5 tasks, maml 20 episodes of 32 tasks), the
        mean of the second half of the logged losses below the first half's,
        then ``evaluate()`` from the checkpoint: every AUC above 0.5,
        dselect_k's accuracies above 0.1, maml's 5-way query accuracy after
        adaptation above 0.2 (chance); K1 and K1b launches per step and per
        evaluated batch as ``mt_launches`` says;
      * mmoe and esmm exported from their checkpoints and served by
        ``run_predict`` at batch 32 and 1024 (``REST_SERVE_TIMED`` timed batches of 1024),
        the first 512 rows against the port's CPU run (atol 1e-5); metaheac
        served at batch 32 through its grad-enabled inference, every
        prediction against the CPU run;
      * ``torch.profiler`` over the esmm, metaheac and maml train step."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}, "runs": {}}
    data_dirs, cfgs = {}, {}
    for i, model in enumerate(MULTITASK):
        md = load_model_def(mt_config(model))
        data = data_dirs[model] = os.path.join(work, f"mt_{model}")
        _mt_data(model, data, _mt_rows(model, md), seed + 20 + i, md)
        ckpt = os.path.join(work, f"ckpt_{model}")
        cfg = cfgs[model] = mt_config(
            model, **{"runner.train_data_dir": data, "runner.test_data_dir": data,
                      "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
                      "runner.epochs": 2, "runner.print_interval": 2,
                      "runner.episodes_per_epoch": MT_EPISODES})
        trainer = Trainer(cfg)
        trainer.init_state(seed=seed)
        (fwd_k1, fwd_k1b), (step_k1, step_k1b) = mt_launches(trainer.model_def)
        lines = LossLines()
        logger.addHandler(lines)
        _reset(gp)
        try:
            t0 = time.perf_counter()
            metrics = trainer.train()
            seconds = time.perf_counter() - t0
        finally:
            logger.removeHandler(lines)
        steps = trainer.state.step
        launched = _counts(gp)
        losses = lines.losses
        half = len(losses) // 2
        if launched[:2] != (step_k1 * steps, step_k1b * steps) or steps < 2 * MT_EPISODES:
            raise AssertionError(f"{model}: {steps} steps launched K1, K1b {launched[:2]}")
        if (len(losses) < 4 or not np.all(np.isfinite(losses))
                or not np.mean(losses[half:]) < np.mean(losses[:half])):
            raise AssertionError(f"{model}: the loss did not fall: {losses}")
        _add_launched(out, launched)
        _reset(gp)
        t0 = time.perf_counter()
        evaluated = trainer.evaluate(epoch_tag=1)
        eval_seconds = time.perf_counter() - t0
        eval_batches = sum(1 for _ in trainer.make_dataset(data, SEQ_BATCH))
        eval_launched = _counts(gp)
        if eval_launched[:2] != (fwd_k1 * eval_batches, fwd_k1b * eval_batches):
            raise AssertionError(f"{model}: {eval_batches} evaluated batches launched K1, "
                                 f"K1b {eval_launched[:2]}")
        _add_launched(out, eval_launched)
        checks = {k: v for k, v in evaluated.items() if k.startswith(("auc", "acc"))}
        floor = {"dselect_k": 0.1, "maml": 0.2}.get(model, 0.5)
        if not checks or not all(np.isfinite(v) and v > floor for v in checks.values()):
            raise AssertionError(f"{model}: evaluate() {checks}, each must be above {floor}")
        run = {"model": model, "batch_size": SEQ_BATCH, "steps": steps, "epochs": 2,
               "logged_losses": losses, "train_seconds_with_checkpoints": seconds,
               "last_epoch_seconds": metrics["epoch_time"],
               # the trainer counts a batch's leading axis: tasks for maml
               # and metaheac, rows for the others
               "last_epoch_examples_per_s": metrics["ips"],
               "last_epoch_steps_per_s": steps / 2 / metrics["epoch_time"],
               "k1_launches": launched[0], "k1b_launches": launched[1],
               "eval": {**checks, "batches": eval_batches, "seconds": eval_seconds,
                        "examples_per_s": evaluated["ips"], "floor": floor,
                        "k1_launches": eval_launched[0], "k1b_launches": eval_launched[1]}}
        out["runs"][model] = run
        emit({"train": run, "card": card})
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    for model in ("mmoe", "esmm", "metaheac"):
        md = load_model_def(cfgs[model])
        data = os.path.join(work, f"mt_{model}_serve")
        if model == "metaheac":
            rows, batches = MT_SERVE_BATCHES * 2 * SEQ_BATCH * md.task_count, (SEQ_BATCH,)
        else:
            rows, batches = MT_SERVE_ROWS, SEQ_SERVE
        _mt_data(model, data, rows, seed + 30, md)
        export_dir = os.path.join(work, f"export_{model}")
        t0 = time.perf_counter()
        export_model(mt_config(model, **{"runner.model_init_path": os.path.join(
            work, f"ckpt_{model}", "1")}), export_dir)
        twin = data
        if model != "metaheac":
            # the CPU twin predicts the first rows only: a row's prediction
            # does not depend on the others in its batch
            twin = f"{data}_head"
            with open(os.path.join(data, "part-0")) as fh:
                _write_lines(twin, [fh.readline().rstrip("\n") for _ in range(REST_TWIN_ROWS)])
        cpu_preds = np.concatenate(run_predict(export_dir, twin, SEQ_BATCH, device="cpu")[0])
        (fwd_k1, fwd_k1b), _ = mt_launches(md)
        for batch in batches:
            _reset(gp)
            served, report = run_predict(export_dir, data, batch)
            launched = _counts(gp)
            preds = np.concatenate(served)[:len(cpu_preds)]
            err = float(np.abs(preds - cpu_preds).max())
            forwards = (MT_SERVE_BATCHES if model == "metaheac"
                        else math.ceil(rows / batch))
            if launched[:2] != (fwd_k1 * forwards, fwd_k1b * forwards):
                raise AssertionError(f"{model}: K1, K1b {launched[:2]} at batch {batch}")
            if (preds.shape != cpu_preds.shape or not np.ptp(preds) > 0
                    or not np.all(np.isfinite(preds)) or err > ZOO_ATOL
                    or report["batches"] < REST_SERVE_TIMED):
                raise AssertionError(f"{model}: served predictions, card vs CPU max err {err}, "
                                     f"{report}")
            _add_launched(out, launched)
            emit({"predict": {"model": model, "batch_size": batch, "rows": rows, **report,
                              "max_abs_err_vs_cpu": err, "rows_vs_cpu": int(len(cpu_preds)),
                              "k1_launches": launched[0], "k1b_launches": launched[1],
                              "seconds_export_and_predict": time.perf_counter() - t0},
                  "card": card})
        shutil.rmtree(export_dir)
    # metaheac's and maml's steps run many thousands of kernels: the
    # profiler's own bookkeeping grows with them, so those two profile one step
    for model, iters in (("esmm", 5), ("metaheac", 1), ("maml", 1)):
        emit({"profile_train": profile_train(mt_config(model), SEQ_BATCH, seed, iters=iters),
              "card": card})
    return out


def _second_order(gp, fn, table, spt, qry, mode: str, lr: float = 1.0):
    """The meta-gradient of the JAX models' inner step, through ``fn``: the
    table's gradient of a support read-out, a step of it, the gradient of a
    query read-out at the stepped table.  ``spt``/``qry``: (ids, mask,
    weights)."""
    t = table.clone().requires_grad_()
    out = fn(t, spt[0], spt[1], mode=mode)
    (g,) = torch.autograd.grad(torch.sum(spt[2] * torch.tanh(out)), t, create_graph=True)
    out = fn(t - lr * g, qry[0], qry[1], mode=mode)
    torch.sum(qry[2] * torch.sin(out)).backward()
    return t.grad


@_uncounted
def check_second_order(gp, seed: int, card: str) -> list:
    """Phase 21: ``autograd.grad`` of ``autograd.grad`` through K1 and K1b
    (``_second_order``) against the same through the plain version, at
    metaheac's ``dynamic_3`` shape (263,313 × 64, fill mode, 320 ids a
    read, a tenth of the support's ids out of range both ways) and at the
    Ali-CCP table's view (737,952 × 16, clip mode, N = 736, L = 3, masked,
    ids out of range among them).  Three K1 and three K1b launches each.
    Tolerance rtol 1e-5, atol 1e-5: K1b's atomics add in another order, and
    the second order sums those sums again."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for name, rows, dim, n, pool, mode in (
            ("metaheac dynamic_3, fill", 263313, 64, 32 * 10, 1, "fill"),
            ("Ali-CCP view, clip, masked", 737952, 16, 32 * 23, 3, "clip")):
        table = torch.randn(rows, dim, device="cuda", generator=g)
        ids = torch.randint(0, rows, (n, pool), device="cuda", generator=g, dtype=torch.int32)
        out_of_range = torch.rand(n, pool, device="cuda", generator=g) < 0.1
        far = torch.randint(rows, 2 * rows, (n, pool), device="cuda", generator=g,
                            dtype=torch.int32)
        spt_ids = torch.where(out_of_range, far * (1 - 2 * (far % 2)), ids)
        # the query reads in range, half of it rows the support read
        qry_ids = torch.where(torch.rand(n, pool, device="cuda", generator=g) < 0.5,
                              ids.flip(0), torch.randint(0, rows, (n, pool), device="cuda",
                                                         generator=g, dtype=torch.int32))
        masks = [None if pool == 1 else
                 (torch.rand(n, pool, device="cuda", generator=g) < 0.7).float()
                 for _ in range(2)]
        weights = [torch.randn(n, dim, device="cuda", generator=g) for _ in range(2)]
        spt, qry = (spt_ids, masks[0], weights[0]), (qry_ids, masks[1], weights[1])
        _reset(gp)
        got = _second_order(gp, gp.gather_pool, table, spt, qry, mode)
        launched = _counts(gp)[:2]
        want = _second_order(gp, gp.gather_pool_plain, table, spt, qry, mode)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check = {"shape": name, "rows": rows, "dim": dim, "n": n, "pool": pool, "mode": mode,
                 "ids_out_of_range": int(out_of_range.sum()), "launches": launched,
                 "max_abs_err": err, "grad_max": float(want.abs().max()),
                 "tolerance": {"rtol": 1e-5, "atol": 1e-5},
                 "ok": bool(launched == (3, 3) and torch.isfinite(got).all()
                            and torch.allclose(got, want, rtol=1e-5, atol=1e-5))}
        checks.append(check)
        if not check["ok"]:
            raise AssertionError(f"the second order through K1/K1b disagrees: {check}")
        del table, got, want
    emit({"second_order_checks": checks, "card": card})
    return checks


# the multitask family's new lookups at batch 32 (and the Ali-CCP models'
# serving batch 1024): (shape, rows, D, N, L, mode)
MT_SHAPES = (
    ("Ali-CCP view, masked L=3, B=32", 737952, 16, 32 * 23, 3, "clip"),
    ("Ali-CCP view, masked L=3, B=1024", 737952, 16, 1024 * 23, 3, "clip"),
    ("metaheac dynamic_3, one task's support", 263313, 64, 32 * 10, 1, "fill"),
    # K1 as K1b's backward: the gather of dynamic_3's table-shaped gradient,
    # where the ids K1b dropped read zero
    ("K1 as K1b's backward, dynamic_3's gradient", 263313, 64, 32 * 10, 1, "fill_drop"),
)


@_uncounted
def check_multitask_shapes(gp, seed: int, card: str) -> None:
    """Phase 22, before the timing: K1 and K1b at ``MT_SHAPES`` against their
    plain versions: K1 with one id a row bitwise, a masked pool rtol 1e-5 and
    atol 1e-6; K1b rtol 1e-5 and atol 1e-6 times the most adds a row takes,
    atomics adding in another order.  Both are then timed at the same shapes
    (``time_k1_shapes``, ``time_k1b_shapes``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for name, rows, dim, n, pool, mode in MT_SHAPES:
        table = torch.randn(rows, dim, device="cuda", generator=g)
        mask = (None if pool == 1 else
                (torch.rand(n, pool, device="cuda", generator=g) < 0.7).float())
        ids = torch.randint(0, rows, (n, pool), device="cuda", generator=g, dtype=torch.int32)
        if mode == "fill_drop":  # a tenth of the ids out of range, as K1b dropped them
            ids = torch.where(torch.rand(n, pool, device="cuda", generator=g) < 0.1,
                              ids + rows, ids)
        grad = torch.randn(n, dim, device="cuda", generator=g)
        adds = int(torch.bincount(ids.reshape(-1).long().clamp(0, rows)).max())
        out = gp.gather_pool(table, ids, mask, mode=mode)
        ref = gp.gather_pool_plain(table, ids, mask, mode=mode)
        dt = gp.gather_pool_bwd(grad, ids, mask, rows, mode=mode)
        dt_ref = gp.gather_pool_bwd_plain(grad, ids, mask, rows, mode=mode)
        torch.cuda.synchronize()
        k1_ok = (torch.equal(out, ref) if pool == 1
                 else torch.allclose(out, ref, rtol=1e-5, atol=1e-6))
        check = {"shape": name, "n": n, "pool": pool, "dim": dim, "rows": rows, "mode": mode,
                 "most_adds_per_row": adds,
                 "k1_max_abs_err": float((out - ref).abs().max()), "k1_ok": bool(k1_ok),
                 "k1_tolerance": "bitwise" if pool == 1 else {"rtol": 1e-5, "atol": 1e-6},
                 "k1b_max_abs_err": float((dt - dt_ref).abs().max()),
                 "k1b_tolerance": {"rtol": 1e-5, "atol": 1e-6 * adds},
                 "k1b_ok": bool(torch.allclose(dt, dt_ref, rtol=1e-5, atol=1e-6 * adds))}
        checks.append(check)
        if not (check["k1_ok"] and check["k1b_ok"]):
            raise AssertionError(f"a kernel disagrees with its plain version: {check}")
        del table, ids, grad, out, ref, dt, dt_ref
    emit({"multitask_kernel_checks": checks, "card": card})


# -- the match, content-understanding and recall models (phases 23-25) -------
MATCH = ("match.dssm", "match.multiview_simnet", "match.match_pyramid", "match.kim",
         "contentunderstanding.textcnn", "contentunderstanding.tagspace", "recall.ncf",
         "recall.word2vec")
# K1 launches per forward and K1b per step: one per Embed table (multiview's
# two views in one pooled launch, tagspace's tags and word2vec's output tables
# read for the positive and the negatives at once, kim's clicked and candidate
# titles in one launch)
MATCH_TABLES = {"match.dssm": 0, "match.multiview_simnet": 1, "match.match_pyramid": 1,
                "match.kim": 1, "contentunderstanding.textcnn": 1,
                "contentunderstanding.tagspace": 2, "recall.ncf": 4, "recall.word2vec": 3}
MATCH_STEPS = 50  # steps an epoch at the configs' batch 32
KIM_STEPS = 12  # kim's: a batch of 32 carries 64 MB of one-hop entity vectors
W2V_SENTENCES = 120  # word2vec's sentences: about 280 windows of 32 pairs an epoch
MATCH_SERVED = ("match.match_pyramid", "contentunderstanding.textcnn",
                "contentunderstanding.tagspace")  # served at batch 32 and 1024
KIM_SERVE_BATCHES = 11  # kim served at batch 32: a warm-up and ten timed
KIM_TWIN_ROWS = 32  # the served kim rows its CPU twin predicts too


def slice_config(model: str, **extra):
    """The config of a model of phases 23-25 (``configs/<family>/<name>/
    config.yaml``), with ``extra`` flat keys."""
    from paddlerec_tpu_torch.core.config import Config, load_config

    family, name = model.split(".")
    cfg = load_config(os.path.join(ROOT, "configs", family, name, "config.yaml"))
    return Config({**cfg.to_dict(), **extra}) if extra else cfg


def _bits(v: np.ndarray) -> str:
    """A 0/1 vector as comma-separated digits."""
    buf = np.full(2 * len(v) - 1, ord(","), np.uint8)
    buf[0::2] = v.astype(np.uint8) + ord("0")
    return buf.tobytes().decode()


def _ids(a) -> str:
    return " ".join(map(str, a))


def write_dssm_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``DSSMDataset`` rows at ``trigram_d`` with a planted signal: 20 topics
    of 100 trigrams; the query and the positive take 15 trigrams of one
    topic, each negative 15 of another, every vector 5 more anywhere."""
    rng = np.random.RandomState(seed)
    d, topics = md.trigram_d, 20

    def vec(t):
        v = np.zeros(d, np.uint8)
        v[t * 100 + rng.choice(100, 15, replace=False)] = 1
        v[rng.randint(0, d, 5)] = 1
        return _bits(v)

    lines = []
    for _ in range(rows):
        t = rng.randint(topics)
        negs = [vec((t + rng.randint(1, topics)) % topics) for _ in range(md.neg_num)]
        lines.append("\t".join([vec(t), vec(t)] + negs))
    _write_lines(data_dir, lines)


def write_multiview_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``MultiviewDataset`` rows: each slot 3 to ``max_len`` words of one of
    50 topics (200 words each); consecutive rows take different topics, so
    that the in-batch negative, the previous row's title, is off topic."""
    rng = np.random.RandomState(seed)

    def slot(topic):
        return _ids(topic * 200 + rng.randint(0, 200, rng.randint(3, md.max_len + 1)))

    lines, topic = [], 0
    for _ in range(rows):
        topic = (topic + rng.randint(1, 50)) % 50
        lines.append(";".join(slot(topic) for _ in range(md.query_slots)) + "\t"
                     + ";".join(slot(topic) for _ in range(md.title_slots)))
    _write_lines(data_dir, lines)


def write_match_pyramid_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``MatchPyramidDataset`` rows in pairs over one left text (20,000
    words): the first, label 1, has a right text of which a third of the
    words are the left's; the second, label 0, a right text of other words.
    Row i belongs to query i // 2."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        if i % 2 == 0:
            left = rng.randint(0, 20000, md.left_size)
        right = rng.randint(0, 20000, md.right_size)
        if i % 2 == 0:
            take = rng.rand(md.right_size) < 1 / 3
            right[take] = left[rng.randint(0, md.left_size, int(take.sum()))]
        lines.append(f"{','.join(map(str, left))}\t{','.join(map(str, right))}\t{1 - i % 2}")
    _write_lines(data_dir, lines)


def write_kim_data(data_dir: str, rows: int, seed: int, md, topics: int = 20,
                   per_topic: int = 20, entities: int = 2000) -> None:
    """``KIMDataset``'s four files at the widths of ``md`` with a planted
    signal: 20 topics, each with its band of title words (a twentieth of the
    vocabulary) and of entities; an entity's vector is its topic's centroid
    plus noise, its ten neighbours of its topic; a user clicks 30 to 60 news
    of one topic (the last ``max_sents`` are kept), the positive is of that
    topic, the ``npratio`` negatives of others."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    band, eband = md.vocab_size // topics, entities // topics
    centroids = rng.randn(topics, 100)
    emb = centroids[np.arange(entities) // eband] * 0.1 + rng.randn(entities, 100) * 0.05
    np.save(os.path.join(data_dir, "entity_emb.npy"), emb.astype(np.float32))
    with open(os.path.join(data_dir, "news.tsv"), "w") as fh:
        for t in range(topics):
            for j in range(per_topic):
                words = t * band + rng.randint(0, band, rng.randint(10, md.max_sentence + 1))
                ents = t * eband + rng.randint(0, eband, rng.randint(3, md.max_entity + 1))
                fh.write(f"N{t}_{j}\t{_ids(words)}\t{_ids(ents)}\n")
    with open(os.path.join(data_dir, "graph.tsv"), "w") as fh:
        for e in range(entities):
            fh.write(_ids([e, *((e // eband) * eband + rng.randint(0, eband, 10))]) + "\n")
    lines = []
    for _ in range(rows):
        t = rng.randint(topics)
        clicked = ",".join(f"N{t}_{j}" for j in rng.randint(0, per_topic, rng.randint(30, 61)))
        negs = ",".join(f"N{(t + rng.randint(1, topics)) % topics}_{rng.randint(per_topic)}"
                        for _ in range(md.npratio))
        lines.append(f"{clicked}\tN{t}_{rng.randint(per_topic)}\t{negs}")
    with open(os.path.join(data_dir, "behaviors.tsv"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_textcnn_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``TextCNNDataset`` lines of 20 to ``max_len`` words: a tenth of a
    positive row's words come from a band of 500 words, of a negative row's
    from another band of 500, the rest from the whole vocabulary."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        label = int(rng.rand() < 0.5)
        n = rng.randint(20, md.max_len + 1)
        toks = rng.randint(1000, md.dict_dim, n)
        k = rng.rand(n) < 0.1
        toks[k] = (0 if label else 500) + rng.randint(0, 500, int(k.sum()))
        lines.append(_ids([*toks, n, label]))
    _write_lines(data_dir, lines)


def write_tagspace_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``TagSpaceDataset`` lines of 8 to ``max_len`` words, a third of them
    from the tag's band of 1,000 words."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        tag = rng.randint(md.vocab_tag_size)
        toks = rng.randint(10000, md.vocab_text_size, rng.randint(8, md.max_len + 1))
        k = rng.rand(len(toks)) < 1 / 3
        toks[k] = tag * 1000 + rng.randint(0, 1000, int(k.sum()))
        lines.append(f"{_ids(toks)}\t{tag}")
    _write_lines(data_dir, lines)


def write_ncf_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``NCFDataset`` lines over 300 users and 200 items: an item below 100 is
    liked (label 1) four times in five, the others one time in five."""
    rng = np.random.RandomState(seed)
    users, items = rng.randint(0, 300, rows), rng.randint(0, 200, rows)
    liked = rng.rand(rows) < np.where(items < 100, 0.8, 0.2)
    _write_lines(data_dir, [f"{u},{i},{int(y)}" for u, i, y in zip(users, items, liked)])


def write_word2vec_data(data_dir: str, rows: int, seed: int, md) -> None:
    """``SkipGramDataset`` sentences of 10 to 20 words of one of 10 groups of
    20 words: words co-occur within their group (the other words of the
    vocabulary are never seen, and never drawn as negatives)."""
    rng = np.random.RandomState(seed)
    _write_lines(data_dir, [
        _ids(g * 20 + rng.randint(0, 20, rng.randint(10, 21)))
        for g in rng.randint(0, min(10, md.vocab_size // 20), rows)])


MATCH_WRITERS = {
    "match.dssm": write_dssm_data, "match.multiview_simnet": write_multiview_data,
    "match.match_pyramid": write_match_pyramid_data, "match.kim": write_kim_data,
    "contentunderstanding.textcnn": write_textcnn_data,
    "contentunderstanding.tagspace": write_tagspace_data, "recall.ncf": write_ncf_data,
    "recall.word2vec": write_word2vec_data,
}


def _match_rows(model: str) -> int:
    if model == "match.kim":
        return KIM_STEPS * SEQ_BATCH
    return W2V_SENTENCES if model == "recall.word2vec" else MATCH_STEPS * SEQ_BATCH


def _head(model: str, data: str, rows: int) -> str:
    """A copy of ``data`` that holds its first ``rows`` rows (kim: behavior
    rows, beside the same news, graph and entity files)."""
    head = f"{data}_head"
    name = "behaviors.tsv" if model == "match.kim" else "part-0"
    with open(os.path.join(data, name)) as fh:
        lines = [fh.readline().rstrip("\n") for _ in range(rows)]
    os.makedirs(head, exist_ok=True)
    if model == "match.kim":
        for other in ("news.tsv", "graph.tsv", "entity_emb.npy"):
            shutil.copy(os.path.join(data, other), head)
    with open(os.path.join(head, name), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return head


def _served_similarities(export_dir: str, data: str, batch: int) -> dict:
    """tagspace's positive and negative similarities (``run_predict`` writes
    none) on the first batch of ``data``, from the artifact loaded on each
    device."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.tools.export import load_exported

    out = {}
    for device in (None, "cpu"):
        md, module = load_exported(export_dir, device)
        host = next(iter(md.make_dataset(data, batch)))
        with torch.inference_mode():
            aux = md.infer_forward(module, to_tensors(host, next(module.parameters()).device))
        out[device or "cuda"] = np.concatenate([aux["pos_sim"].cpu().numpy().reshape(-1),
                                                aux["neg_sim"].cpu().numpy().reshape(-1)])
    return out


def match_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 24, the eight models through the entry points at the full width
    of their configs, batch 32, on rows written in each reader's format with
    a planted signal (``MATCH_WRITERS``):
      * ``Trainer.train()`` for two epochs (``MATCH_STEPS`` steps each;
        kim ``KIM_STEPS``, word2vec the windows of ``W2V_SENTENCES``
        sentences), the loss falling, then ``evaluate()`` from the
        checkpoint with ``pnr``/``auc`` above 0.5; K1 and K1b launches per
        table, step and evaluated batch;
      * match_pyramid, textcnn and tagspace exported from their checkpoints
        and served by ``run_predict`` at batch 32 and 1024 (``REST_SERVE_TIMED`` timed
        batches of 1024), kim at batch 32, the first rows against the port's
        CPU run (atol 1e-5; tagspace, whose aux holds no prediction that
        ``run_predict`` writes, on its similarities through
        ``load_exported``);
      * ``cal_pos_neg`` on match_pyramid's served scores (a query per pair
        of rows), more pairs ordered than misordered;
      * word2vec's checkpoint through ``tools.analogy_eval`` on the card and
        on the CPU, on questions whose answer is the nearest word half of the
        time: the same accuracy;
      * ``torch.profiler`` over one kim and one tagspace step."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.tools import analogy_eval
    from paddlerec_tpu_torch.tools.cal_pos_neg import cal_pos_neg
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.checkpoint import load_params_from_state

    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}, "runs": {}}
    defs = {}
    for i, model in enumerate(MATCH):
        name = model.split(".")[1]
        md = defs[model] = load_model_def(slice_config(model))
        data = os.path.join(work, f"{name}_data")
        MATCH_WRITERS[model](data, _match_rows(model), seed + 24 + i, md)
        ckpt = os.path.join(work, f"ckpt_{name}")
        steps = KIM_STEPS if model == "match.kim" else MATCH_STEPS
        cfg = slice_config(model, **{
            "runner.train_data_dir": data, "runner.test_data_dir": data,
            "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
            "runner.epochs": 2, "runner.print_interval": max(1, steps // 10)})
        run = run_training(gp, cfg, seed, tables=MATCH_TABLES[model], min_steps=2 * steps)
        run["model"] = model
        _add_run(out, run)
        out["runs"][model] = run
        emit({"train": run, "card": card})
        gc.collect()
        torch.cuda.empty_cache()

    for model in MATCH_SERVED + ("match.kim",):
        name, md = model.split(".")[1], defs[model]
        kim = model == "match.kim"
        data = os.path.join(work, f"{name}_serve")
        rows = KIM_SERVE_BATCHES * SEQ_BATCH if kim else REST_SERVE_ROWS
        MATCH_WRITERS[model](data, rows, seed + 40, md)
        export_dir = os.path.join(work, f"export_{name}")
        t0 = time.perf_counter()
        export_model(slice_config(model, **{"runner.model_init_path": os.path.join(
            work, f"ckpt_{name}", "1")}), export_dir)
        twin_rows = KIM_TWIN_ROWS if kim else REST_TWIN_ROWS
        twin = _head(model, data, twin_rows)
        cpu_preds = run_predict(export_dir, twin, SEQ_BATCH, device="cpu")[0]
        cpu_preds = np.concatenate(cpu_preds) if cpu_preds else None
        tables = MATCH_TABLES[model]
        checks = {}
        if cpu_preds is None:  # tagspace: its similarities, on the first batch
            _reset(gp)
            sims = _served_similarities(export_dir, twin, SEQ_BATCH)
            _add_launched(out, _counts(gp))
            checks["similarities_max_abs_err_vs_cpu"] = float(
                np.abs(sims["cuda"] - sims["cpu"]).max())
            if not (checks["similarities_max_abs_err_vs_cpu"] <= ZOO_ATOL
                    and np.ptp(sims["cuda"]) > 0):
                raise AssertionError(f"{model}: served similarities, card vs CPU {checks}")
        for batch in ((SEQ_BATCH,) if kim else SEQ_SERVE):
            _reset(gp)
            served, report = run_predict(export_dir, data, batch)
            launched = _counts(gp)
            if (launched[:2] != (tables * math.ceil(rows / batch), 0)
                    or report["batches"] < REST_SERVE_TIMED):
                raise AssertionError(f"{model}: K1, K1b {launched[:2]} at batch {batch}, "
                                     f"{report}")
            _add_launched(out, launched)
            result = {"model": model, "batch_size": batch, "rows": rows, **report,
                      **checks, "k1_launches": launched[0]}
            if cpu_preds is not None:
                preds = np.concatenate(served)
                err = float(np.abs(preds[:len(cpu_preds)] - cpu_preds).max())
                if (not np.all(np.isfinite(preds)) or not np.ptp(preds) > 0
                        or err > ZOO_ATOL):
                    raise AssertionError(f"{model}: served predictions, card vs CPU "
                                         f"max err {err}")
                result.update(max_abs_err_vs_cpu=err, rows_vs_cpu=int(len(cpu_preds)))
            if model == "match.match_pyramid" and batch == SEQ_SERVE[-1]:
                scores = os.path.join(work, "match_pyramid_scores.txt")
                with open(scores, "w") as fh:
                    fh.writelines(f"q{i // 2}\t{p}\t{1 - i % 2}\n" for i, p in enumerate(preds))
                pnr = cal_pos_neg(scores)
                # the ordered pairs outnumber the misordered (PNR above 0.5;
                # with none misordered the tool reports no ratio)
                if not (pnr["pair_num"] > 0 and pnr["pos_num"] > pnr["neg_num"]):
                    raise AssertionError(f"cal_pos_neg on the served scores: {pnr}")
                result["cal_pos_neg"] = pnr
            result["seconds_export_and_predict"] = time.perf_counter() - t0
            emit({"predict": result, "card": card})
        shutil.rmtree(export_dir)
        gc.collect()
        torch.cuda.empty_cache()

    # word2vec's analogies: the nearest word to b - a + c (a, b, c left out)
    # half of the time, a random word otherwise, from the trained table
    ckpt = os.path.join(work, "ckpt_word2vec")
    emb = load_params_from_state(ckpt, 1)["in_emb.embedding"].numpy().astype(np.float64)
    rng = np.random.RandomState(seed + 41)
    q = rng.randint(0, emb.shape[0], (400, 3))
    dist = (emb[q[:, 1]] - emb[q[:, 0]] + emb[q[:, 2]]) @ (
        emb / np.linalg.norm(emb, axis=1, keepdims=True)).T
    for i in range(3):
        dist[np.arange(len(q)), q[:, i]] = -np.inf
    d = np.where(rng.rand(len(q)) < 0.5, dist.argmax(1), rng.randint(0, emb.shape[0], len(q)))
    qfile = os.path.join(work, "analogies.txt")
    with open(qfile, "w") as fh:
        fh.writelines(_ids(row) + "\n" for row in np.c_[q, d])
    args = ["-m", os.path.join(ROOT, "configs", "recall", "word2vec", "config.yaml"), "-o",
            f"runner.analogy_file={qfile}", f"runner.infer_load_path={ckpt}"]
    on_card = analogy_eval.main(args)
    on_cpu = analogy_eval.main(args + ["--device", "cpu"])
    if (on_card["analogy_acc"] != on_cpu["analogy_acc"] or on_card["questions"] != len(q)
            or not on_card["analogy_acc"] >= 0.4):
        raise AssertionError(f"analogy_eval: card {on_card}, CPU {on_cpu}")
    emit({"analogy_eval": {"card": on_card, "cpu": on_cpu}, "card": card})
    for model, iters in (("match.kim", 3), ("contentunderstanding.tagspace", 5)):
        emit({"profile_train": profile_train(slice_config(model), SEQ_BATCH, seed, iters=iters),
              "card": card})
    return out


# the match, content-understanding and recall models' lookups in phases 23 and
# 24, each one K1 launch in fill mode: (shape, rows, D, N, L, trained: K1b
# at the shape too); the served batch 1024 of match_pyramid, textcnn and
# tagspace is a forward only
MATCH_SHAPES = (
    ("multiview_simnet bag of words, both views, L=8", 89777, 128, 32 * 2, 8, True),
    ("match_pyramid left + right words, B=32", 193368, 50, 32 * 520, 1, True),
    ("match_pyramid left + right words, B=1024", 193368, 50, 1024 * 520, 1, False),
    ("kim title words, 50 clicked + 5 candidates", 1891, 300, 32 * 55 * 30, 1, True),
    ("kim title words, the CPU twin's batch (phase 23)", 1891, 300,
     TWIN_ROWS["match.kim"] * 55 * 30, 1, True),
    ("textcnn words, B=32", 33257, 128, 32 * 100, 1, True),
    ("textcnn words, B=1024", 33257, 128, 1024 * 100, 1, False),
    ("tagspace text, B=32", 75378, 10, 32 * 32, 1, True),
    ("tagspace text, B=1024", 75378, 10, 1024 * 32, 1, False),
    ("tagspace tags, positive + 3 negatives, B=32", 4, 10, 32 * 4, 1, True),
    ("tagspace tags, B=1024", 4, 10, 1024 * 4, 1, False),
    ("ncf mf_user", 6040, 8, 32, 1, True),
    ("ncf mf_item", 3706, 8, 32, 1, True),
    ("ncf mlp_user", 6040, 32, 32, 1, True),
    ("ncf mlp_item", 3706, 32, 32, 1, True),
    ("word2vec in_emb, centers", 1000, 300, 32, 1, True),
    ("word2vec out_emb, positive + 5 negatives", 1000, 300, 32 * 6, 1, True),
    ("word2vec out_bias, positive + 5 negatives", 1000, 1, 32 * 6, 1, True),
)


@_uncounted
def check_match_shapes(gp, seed: int, card: str) -> None:
    """Phase 25, before the timing: K1 and K1b at ``MATCH_SHAPES`` against
    their plain versions, in fill mode (multiview's bags masked): K1 with one
    id a row bitwise, a masked pool rtol 1e-5 and atol 1e-6; K1b rtol 1e-5
    and atol 1e-6 times the most adds a row takes, atomics adding in another
    order.  Both are then timed at the same shapes (``time_k1_shapes``,
    ``time_k1b_shapes``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for name, rows, dim, n, pool, trained in MATCH_SHAPES:
        table = torch.randn(rows, dim, device="cuda", generator=g)
        mask = (None if pool == 1 else
                (torch.rand(n, pool, device="cuda", generator=g) < 0.7).float())
        ids = torch.randint(0, rows, (n, pool), device="cuda", generator=g, dtype=torch.int32)
        out = gp.gather_pool(table, ids, mask, mode="fill")
        ref = gp.gather_pool_plain(table, ids, mask, mode="fill")
        k1_ok = (torch.equal(out, ref) if pool == 1
                 else torch.allclose(out, ref, rtol=1e-5, atol=1e-6))
        check = {"shape": name, "n": n, "pool": pool, "dim": dim, "rows": rows,
                 "k1_max_abs_err": float((out - ref).abs().max()), "k1_ok": bool(k1_ok),
                 "k1_tolerance": "bitwise" if pool == 1 else {"rtol": 1e-5, "atol": 1e-6}}
        if trained:
            grad = torch.randn(n, dim, device="cuda", generator=g)
            adds = int(torch.bincount(ids.reshape(-1).long()).max())
            dt = gp.gather_pool_bwd(grad, ids, mask, rows, mode="fill")
            dt_ref = gp.gather_pool_bwd_plain(grad, ids, mask, rows, mode="fill")
            check.update(most_adds_per_row=adds,
                         k1b_max_abs_err=float((dt - dt_ref).abs().max()),
                         k1b_tolerance={"rtol": 1e-5, "atol": 1e-6 * adds},
                         k1b_ok=bool(torch.allclose(dt, dt_ref, rtol=1e-5, atol=1e-6 * adds)))
        torch.cuda.synchronize()
        checks.append(check)
        if not (check["k1_ok"] and check.get("k1b_ok", True)):
            raise AssertionError(f"a kernel disagrees with its plain version: {check}")
    emit({"match_kernel_checks": checks, "card": card})


# -- recall's last five and the graph family (phases 26-28) -----------------
GRAPH_SLICE = ("recall.deepwalk", "graph.gnn", "graph.lightgcn", "graph.transformer_conv",
               "graph.deepwalk_million", "recall.mind", "recall.tisas", "recall.ensfm",
               "recall.mhcn")
# K1 launches per inference forward and per train forward (= K1b per step):
# one per Embed table, a table's several id tensors read in one launch (the
# graph models' pair nodes with every hop, mind's history with its targets
# and negatives, tisas's history with its positives and negatives or its
# candidates); ensfm's step adds the gather of its positives' rows of q,
# mhcn's two are the batch's rows of its final user and item embeddings
GRAPH_LAUNCHES = {"recall.tisas": (5, 5), "recall.ensfm": (4, 5), "recall.mhcn": (2, 2)}
GRAPH_SERVE = (SEQ_BATCH, 1024)
SERVE_CALLS = 101  # a warm-up and 100 timed calls a batch size
TISAS_CANDIDATES = 100  # scored a row when served: TiSASRec's 1 + 99 protocol
GRAPH_STEPS = 30  # mind's, tisas's, ensfm's and mhcn's steps an epoch at batch 32
# BlogCatalog (Tang & Liu, KDD 2009; DeepWalk's graph, the configs' 10,312
# nodes): 333,983 undirected edges among 39 groups, a power-law degree
BLOG_EDGES, BLOG_GROUPS = 333_983, 39
SCALE_STEPS = 200  # the batches fed and stepped on the graph of BlogCatalog's size
SCALE_WARM = 50  # of which the first, untimed: the preload thread's passes ahead
# the walkers at scale: deepwalk's Python one, the native engine with a hop of
# samples (graph.lightgcn and graph.transformer_conv read the same feed as
# graph.gnn) and without
SCALE_FEEDS = ("recall.deepwalk", "graph.gnn", "graph.deepwalk_million")


def graph_config(model: str, **extra):
    """The config of a model of phases 26-28 (``configs/<family>/<name>/
    config.yaml``, the ModelDef's default widths, batch 32), with ``extra``
    flat keys; mhcn on its demo graph unless ``extra`` says otherwise."""
    if model == "recall.mhcn":
        extra = {"hyper_parameters.demo_graph": True, **extra}
    return slice_config(model, **extra)


def _graph_batches(md) -> list:
    """Four batches of 32 rows of the model's example batch (entries of
    another leading size, ensfm's catalogue, whole in each)."""
    n = 4 * SEQ_BATCH
    rows = md.example_batch(n)
    return [{k: v[i * SEQ_BATCH:(i + 1) * SEQ_BATCH] if v.shape[0] == n else v
             for k, v in rows.items()} for i in range(4)]


def _shared_perms(md, trainer, seed: int) -> None:
    """mhcn on the card and its CPU twin shuffle alike: the permutations
    drawn on the host from ``seed`` and the step, moved to the device."""
    cls = type(md)

    def draw(generator):
        g = torch.Generator().manual_seed(seed + trainer.state.step)
        return [tuple(p.to(trainer.device) for p in perm) for perm in cls.draw_perms(md, g)]

    md.draw_perms = draw


def _graph_output(md, module, batch) -> np.ndarray:
    """What a forward is compared on: the predictions (the walk and graph
    models, tisas), mind's positive logits, ensfm's (B, I) scores, mhcn's
    BPR loss and its final user embedding."""
    with torch.no_grad():
        aux = md.infer_forward(module, batch)
        if md.registry_name == "recall.mhcn":
            users = md.user_item_embeddings(module)[0]
            return np.concatenate([[float(aux["rec_loss"])], users.cpu().numpy().ravel()])
    key = next(k for k in ("predictions", "pos_logit", "scores") if k in aux)
    return aux[key].cpu().numpy()


def graph_zoo(gp, seed: int, card: str) -> dict:
    """Phase 26: each of ``GRAPH_SLICE`` at the full width of its config,
    batch 32: a module on the card and its twin on the CPU from one seed,
    one inference forward and three train steps on four of the model's
    example batches (mhcn's shuffles the same on both: ``_shared_perms``);
    outputs (``_graph_output``) and losses card against CPU (atol 1e-5),
    with the K1 launches per forward and the K1 and K1b launches per step of
    ``GRAPH_LAUNCHES`` (one and one by default)."""
    from paddlerec_tpu_torch.train.trainer import Trainer

    results, failed = [], []
    totals = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}}
    for model in GRAPH_SLICE:
        cfg = graph_config(model)
        t0 = time.perf_counter()
        host = Trainer(cfg, device="cpu")
        host.init_state(seed=seed)
        chip = Trainer(cfg)
        chip.init_state(seed=seed)
        chip.state.module.load_state_dict(host.state.module.state_dict())
        if host.stochastic:
            for trainer in (host, chip):
                _shared_perms(trainer.model_def, trainer, seed + 26)
        batches = _graph_batches(host.model_def)
        infer_k1, step_k1 = GRAPH_LAUNCHES.get(model, (1, 1))
        twin, launched = _twin_steps(gp, chip, host, batches, _graph_output)
        steps = len(batches) - 1
        (f1, f1b, f1_dim, _), (s1, s1b, s1_dim, s1b_dim) = launched
        if (f1, f1b, s1, s1b) != (infer_k1, 0, step_k1 * steps, step_k1 * steps):
            raise AssertionError(f"{model}: K1, K1b launches {launched}, expected "
                                 f"{infer_k1} a forward and {step_k1} a step")
        _add_launched(totals, (f1 + s1, s1b, {}, s1b_dim))
        _add_dims(totals, "k1_by_dim", f1_dim)
        _add_dims(totals, "k1_by_dim", s1_dim)
        results.append({
            "model": model, **twin, "seed": seed,
            "k1_per_forward": f1, "k1b_per_step": s1b // steps,
            "parameters": sum(p.numel() for p in chip.state.module.parameters()),
            "seconds": time.perf_counter() - t0})
        if not twin["ok"]:
            failed.append(model)
        del host, chip
        gc.collect()
        torch.cuda.empty_cache()
    emit({"graph_zoo": results, "batch_size": SEQ_BATCH, "card": card})
    if failed:
        raise AssertionError(f"card and CPU disagree for {failed}")
    return totals


def _spread_ids(rng, table_rows: int, n: int) -> np.ndarray:
    """``n`` distinct ids spread over a table of ``table_rows`` rows."""
    return rng.choice(table_rows, n, replace=False)


def write_walk_edges(data_dir: str, seed: int, md, groups: int, size: int,
                     files: int = 4) -> None:
    """Edge files ``src dst [etype]`` with a planted signal: ``groups``
    communities of ``size`` nodes spread over the table, each node linked to
    four others of its community (a third of the lines with an edge type),
    one bridge between consecutive communities; ``files`` files."""
    rng = np.random.RandomState(seed)
    nodes = _spread_ids(rng, md.num_nodes, groups * size).reshape(groups, size)
    lines = []
    for g in range(groups):
        for i in range(size):
            for j in rng.choice(np.delete(np.arange(size), i), 4, replace=False):
                etype = f" {rng.randint(3)}" if rng.rand() < 1 / 3 else ""
                lines.append(f"{nodes[g, i]} {nodes[g, j]}{etype}")
        lines.append(f"{nodes[g, 0]} {nodes[(g + 1) % groups, 0]}")
    os.makedirs(data_dir, exist_ok=True)
    for f in range(files):
        with open(os.path.join(data_dir, f"edges_{f}.txt"), "w") as fh:
            fh.write("\n".join(lines[f::files]) + "\n")


def write_blog_edges(data_dir: str, seed: int, num_nodes: int, files: int = 4) -> dict:
    """Edge files ``src dst`` of BlogCatalog's shape over ``num_nodes``
    nodes: ``BLOG_EDGES`` edges whose ends are drawn with weights 1 +
    Pareto(2) (a mean degree of ~65, hubs of a few thousand), the second end
    from the first's group of ``BLOG_GROUPS`` four times in five, self-loops
    dropped; ``files`` files.  Returns the graph's counts."""
    rng = np.random.RandomState(seed)
    w = 1 + rng.pareto(2.0, num_nodes)
    group = rng.randint(BLOG_GROUPS, size=num_nodes)
    order = np.argsort(group, kind="stable")
    cum = np.cumsum(w[order])
    ends = np.searchsorted(group[order], np.arange(BLOG_GROUPS + 1))
    lo = np.where(ends[:-1] > 0, cum[np.maximum(ends[:-1] - 1, 0)], 0.0)
    hi = cum[ends[1:] - 1]

    def draw(a, b):  # a node of weight-cumulative range [a, b) each
        return order[np.minimum(np.searchsorted(cum, a + rng.rand(len(a)) * (b - a),
                                                side="right"), num_nodes - 1)]

    whole = np.zeros(BLOG_EDGES), np.full(BLOG_EDGES, cum[-1])
    src = draw(*whole)
    inside = rng.rand(BLOG_EDGES) < 0.8
    g = group[src]
    dst = np.where(inside, draw(lo[g], hi[g]), draw(*whole))
    edges = np.stack([src, dst], 1)[src != dst]
    os.makedirs(data_dir, exist_ok=True)
    for f in range(files):
        np.savetxt(os.path.join(data_dir, f"edges_{f}.txt"), edges[f::files], fmt="%d")
    degree = np.bincount(edges.ravel(), minlength=num_nodes)
    return {"nodes": int((degree > 0).sum()), "edges": len(edges),
            "mean_degree": float(degree.mean()), "max_degree": int(degree.max())}


def _read_batches(dataset, n: int) -> tuple:
    """(seconds to the first batch, host ms a batch of the next ``n - 1``
    or fewer, batches read) of one epoch of ``dataset`` read alone."""
    batches = iter(dataset)
    t0 = time.perf_counter()
    next(batches)
    t1 = time.perf_counter()
    read = sum(1 for _ in itertools.islice(batches, n - 1))
    return t1 - t0, 1e3 * (time.perf_counter() - t1) / max(read, 1), read + 1


def walk_feeds_at_scale(gp, work: str, seed: int, card: str, out: dict, toy: dict) -> None:
    """The feeds of ``SCALE_FEEDS`` on a graph of BlogCatalog's size at
    their configs' node counts (``write_blog_edges``; deepwalk's 10,312,
    the graph family's 10,000): the dataset ``Trainer.make_dataset`` picks
    (the native engine's ``GraphChunkedDataset`` for ``graph.*``: the run
    fails otherwise) is built (the engine's load), read alone for
    ``SCALE_STEPS`` batches (host ms a batch, the first one apart: the
    first walk pass, or deepwalk's parse of the edges), then fed and stepped
    as ``train()`` does (``_device_batches`` and ``train_step``) for
    ``SCALE_STEPS`` batches of a new epoch: examples/s of those after the
    first ``SCALE_WARM`` (while the preload thread makes its passes ahead),
    ended by a synchronise; one K1 and one K1b launch a step.  The
    same feed is read on the model's planted graph (``toy``, its data
    directory by model) for comparison.  The native feed's two parts are
    timed alone: the engine's neighbour sample of a batch, and the shuffle
    of one walk pass's pairs (``rng.shuffle`` of the (P, 2) rows, as the
    dataset does, against the same permutation drawn on an index)."""
    from paddlerec_tpu_torch.data.graph_dataset import GraphChunkedDataset, window_pairs
    from paddlerec_tpu_torch.train.trainer import Trainer

    graphs = {}
    for model in SCALE_FEEDS:
        trainer = Trainer(graph_config(model))
        trainer.init_state(seed=seed)
        md = trainer.model_def
        data = os.path.join(work, f"blog_{md.num_nodes}")
        if data not in graphs:
            graphs[data] = write_blog_edges(data, seed + 29, md.num_nodes)
        t0 = time.perf_counter()
        dataset = trainer.make_dataset(data, SEQ_BATCH)
        load_s = time.perf_counter() - t0
        if model.startswith("graph.") and not isinstance(dataset, GraphChunkedDataset):
            raise AssertionError(f"{model} did not read through the native engine")
        first_s, feed_ms, read = _read_batches(dataset, SCALE_STEPS)
        toy_first_s, toy_feed_ms, toy_read = _read_batches(
            trainer.make_dataset(toy[model], SEQ_BATCH), SCALE_STEPS)
        parts = {}
        if isinstance(dataset, GraphChunkedDataset) and md.samples:
            nodes = dataset._nodes[:2 * SEQ_BATCH].reshape(SEQ_BATCH, 2)
            t0 = time.perf_counter()
            for i in range(200):
                dataset.engine.sample(nodes, md.samples[0], seed=i)
            parts["sample_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / 200
        if model == "graph.gnn":
            pairs = window_pairs(dataset.engine.walks(
                dataset._nodes[:dataset.chunk_nodes], md.walk_len, seed=seed), md.win_size)
            rows, index = pairs.copy(), np.arange(len(pairs))
            t0 = time.perf_counter()
            np.random.RandomState(seed).shuffle(rows)
            t1 = time.perf_counter()
            np.random.RandomState(seed).shuffle(index)
            shuffled = pairs[index]
            t2 = time.perf_counter()
            if not np.array_equal(rows, shuffled):
                raise AssertionError("a pass's shuffle by rows and by index differ")
            parts.update(pass_pairs=len(pairs), pass_shuffle_rows_ms=1e3 * (t1 - t0),
                         pass_shuffle_index_ms=1e3 * (t2 - t1))
        _reset(gp)
        ms, losses = trainer._init_metric_state(), []
        for i, batch in enumerate(itertools.islice(
                trainer._device_batches(dataset, augment=True), SCALE_STEPS)):
            ms, loss = trainer.train_step(batch, ms)
            losses.append(loss)
            if i == SCALE_WARM - 1:
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t2
        launched = _counts(gp)
        losses = [float(x) for x in losses]
        if (read != SCALE_STEPS or len(losses) != SCALE_STEPS
                or launched[:2] != (SCALE_STEPS, SCALE_STEPS)
                or not np.all(np.isfinite(losses))):
            raise AssertionError(f"{model} at scale: {read} batches read, "
                                 f"{len(losses)} steps, K1, K1b {launched[:2]}")
        _add_launched(out, launched)
        emit({"walk_feed_at_scale": {
            "model": model, "dataset": type(dataset).__name__, **graphs[data],
            "batch_size": SEQ_BATCH, "load_s": load_s, "first_batch_s": first_s,
            "feed_ms_per_batch": feed_ms, "planted_graph_first_batch_s": toy_first_s,
            "planted_graph_feed_ms_per_batch": toy_feed_ms,
            "planted_graph_batches_read": toy_read, **parts, "steps": SCALE_STEPS,
            "examples_per_s_fed_and_stepped": (SCALE_STEPS - SCALE_WARM) * SEQ_BATCH / seconds,
            "first_loss": losses[0], "last_loss": losses[-1]}, "card": card})
        del trainer, dataset
        gc.collect()
    for data in graphs:
        shutil.rmtree(data)


def write_mind_data(data_dir: str, seed: int, md, users: int = 48, events: int = 21) -> None:
    """``MINDDataset`` lines ``user,item,timestamp`` with a planted signal:
    each user's ``events`` items from one of 20 bands of 100 items spread
    over the table, in shuffled line order ((events - 1)·users rows)."""
    rng = np.random.RandomState(seed)
    bands = _spread_ids(rng, md.item_count, 2000).reshape(20, 100)
    lines = []
    for u in range(users):
        band = bands[rng.randint(20)]
        for t in range(events):
            lines.append(f"{u},{band[rng.randint(100)]},{1000 * t + rng.randint(500)}")
    rng.shuffle(lines)
    _write_lines(data_dir, lines)


def write_tisas_data(data_dir: str, seed: int, md, users: int) -> None:
    """``TiSASDataset`` lines ``user item rating timestamp`` with a planted
    signal: 12 to 60 events a user that walk a cycle of 30 items (the next
    item is the cycle's next four times in five), at gaps of one to five
    minutes."""
    rng = np.random.RandomState(seed)
    cycles = _spread_ids(rng, md.item_num, 30 * 20).reshape(20, 30)
    lines = []
    for u in range(users):
        cycle, pos, ts = cycles[rng.randint(20)], rng.randint(30), 1_000_000
        for _ in range(rng.randint(12, 61)):
            lines.append(f"u{u} {cycle[pos]} 4 {ts}")
            pos = (pos + 1) % 30 if rng.rand() < 0.8 else rng.randint(30)
            ts += 60 * rng.randint(1, 6)
    _write_lines(data_dir, lines)


def write_ensfm_data(data_dir: str, seed: int, md, users: int) -> None:
    """``ENSFMDataset`` lines ``ufeat-ufeat,ifeat-ifeat`` with a planted
    signal: each user's 8 positives from one of 20 bands of 50 items."""
    rng = np.random.RandomState(seed)
    bands = rng.permutation(md.num_items)[:1000].reshape(20, 50)
    lines = [f"u{u}-{u % 7},i{i}-{i % 5}" for u in range(users)
             for i in bands[u % 20][rng.choice(50, 8, replace=False)]]
    _write_lines(data_dir, lines)


def mhcn_graph(seed: int, md):
    """A social (U, U) and rating (U, I) 0/1 graph with a planted signal:
    four groups of users and items; a user follows a third of its group and
    rates half of its group's items, and a twentieth of the rest."""
    rng = np.random.RandomState(seed)
    ug, ig = np.arange(md.num_users) % 4, np.arange(md.num_items) % 4
    social = (rng.rand(md.num_users, md.num_users)
              < np.where(ug[:, None] == ug[None], 1 / 3, 0.02)).astype(np.float32)
    np.fill_diagonal(social, 0)
    rating = (rng.rand(md.num_users, md.num_items)
              < np.where(ug[:, None] == ig[None], 0.5, 0.05)).astype(np.float32)
    return social, rating


def write_mhcn_data(data_dir: str, rating: np.ndarray, rows: int, seed: int) -> None:
    """``MHCNDataset`` lines ``user item`` drawn from the rated pairs of
    ``rating``, shuffled, ``rows`` of them."""
    rng = np.random.RandomState(seed)
    pairs = np.argwhere(rating > 0)
    pairs = pairs[rng.randint(0, len(pairs), rows)]
    _write_lines(data_dir, ["userID itemID"] + [f"{u} {i}" for u, i in pairs])


def _serve_calls(model: str, md, module, batch: int, seed: int, device) -> tuple:
    """(the model's serving call on ``batch`` rows made from ``seed`` as a
    function of nothing, K1 launches per call)."""
    from paddlerec_tpu_torch.core.device import to_tensors

    rows = to_tensors(md.example_batch(batch), device)
    if model == "recall.deepwalk":
        nodes = torch.from_numpy(np.random.RandomState(seed).randint(
            0, md.num_nodes, batch)).to(device)
        return (lambda: md.node_embeddings(module, nodes)), 1
    if model == "recall.mind":
        return (lambda: module.user_capsules(rows["hist_items"], rows["seq_mask"])), 1
    if model == "recall.tisas":
        cand = torch.from_numpy(np.random.RandomState(seed).randint(
            1, md.item_num + 1, (batch, TISAS_CANDIDATES))).to(device)
        return (lambda: md.score_items(module, rows["log_seqs"], rows["time_matrices"],
                                       cand)), 5
    if model == "recall.ensfm":
        return (lambda: md.infer_forward(module, rows)["scores"]), 4
    return (lambda: md.user_item_embeddings(module)[0]), 0


def serve_graph_models(gp, trainers: dict, seed: int, card: str, out: dict) -> None:
    """The serving calls of deepwalk (``node_embeddings`` of a batch of
    nodes), mind (``user_capsules``), tisas (``score_items`` of 100
    candidates), ensfm (``infer_forward``'s scores of every item) and mhcn
    (``user_item_embeddings``, the whole graph) on each trained module:
    at batch 32 against a CPU twin of the same parameters (atol 1e-5), then
    ``SERVE_CALLS`` calls at batch 32 and 1024, each ended by a synchronise:
    p50 and p99 wall ms of the 300 after the warm-up, K1 launches per
    call."""
    for model in ("recall.deepwalk", "recall.mind", "recall.tisas", "recall.ensfm",
                  "recall.mhcn"):
        trainer = trainers[model]
        md, module = trainer.model_def, trainer.state.module
        twin = md.make_module(device="cpu")
        twin.load_state_dict(module.state_dict())
        with torch.inference_mode():
            card_fn, per_call = _serve_calls(model, md, module, SEQ_BATCH, seed, trainer.device)
            cpu_fn, _ = _serve_calls(model, md, twin, SEQ_BATCH, seed, torch.device("cpu"))
            _reset(gp)
            err = float((card_fn().cpu() - cpu_fn()).abs().max())
            launched = _counts(gp)
            if not err <= ZOO_ATOL or launched[:2] != (per_call, 0):
                raise AssertionError(f"{model}: served, card vs CPU max err {err}, "
                                     f"K1, K1b {launched[:2]}")
            _add_launched(out, launched)
            for batch in (GRAPH_SERVE if model != "recall.mhcn" else (None,)):
                fn, per_call = _serve_calls(model, md, module, batch or SEQ_BATCH, seed + 1,
                                            trainer.device)
                _reset(gp)
                times = []
                for _ in range(SERVE_CALLS):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                launched = _counts(gp)
                if launched[:2] != (per_call * SERVE_CALLS, 0):
                    raise AssertionError(f"{model}: served K1, K1b {launched[:2]}")
                _add_launched(out, launched)
                timed = np.array(times[1:])
                emit({"serve_call": {
                    "model": model, "batch_size": batch, "calls": len(timed),
                    "p50_ms": float(np.percentile(timed, 50)),
                    "p99_ms": float(np.percentile(timed, 99)),
                    "k1_per_call": per_call, "max_abs_err_vs_cpu_b32": err}, "card": card})
        del twin
        gc.collect()


def graph_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 27, the nine registrations through the entry points at the
    full width of their configs, batch 32, on rows written in each reader's
    format with a planted signal:
      * ``Trainer.train()`` for two epochs, the loss falling, then
        ``evaluate()`` from the checkpoint (``auc`` above 0.5 where the
        model has one); K1 and K1b launches per step and evaluated batch;
        the graph models' batches from the native walk engine
        (``GraphChunkedDataset``: the run fails if it is not built or not
        picked); mhcn on its demo graph and again through ``set_graph`` on a
        seeded graph;
      * the serving calls (``serve_graph_models``);
      * the walk feeds on a graph of BlogCatalog's size
        (``walk_feeds_at_scale``);
      * deepwalk, graph.gnn, tisas and ensfm exported from their checkpoints
        and served by ``run_predict`` at batch 32, card against the port's
        CPU run on the same artifact and rows (atol 1e-5);
      * ``torch.profiler`` over one tisas and one mind step."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.data.graph_dataset import GraphChunkedDataset
    from paddlerec_tpu_torch.native.graph import graph_available
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.train.trainer import Trainer

    if not graph_available():
        raise AssertionError("the native graph engine (native/graph_engine.cpp) did not build")
    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}, "runs": {}}
    trainers, datas = {}, {}
    runs = [(m, m, {}) for m in GRAPH_SLICE]
    runs.append(("recall.mhcn", "recall.mhcn set_graph",
                 {"hyper_parameters.demo_graph": False}))
    for i, (model, label, extra) in enumerate(runs):
        name = label.split(".")[1].replace(" ", "_")
        md = load_model_def(graph_config(model, **extra))
        data = datas[label] = os.path.join(work, f"{name}_data")
        if model == "recall.deepwalk":
            write_walk_edges(data, seed + 27, md, groups=2, size=8)
        elif model.startswith("graph."):
            write_walk_edges(data, seed + 27, md, groups=4, size=12)
        elif model == "recall.mind":
            write_mind_data(data, seed + 27 + i, md)
        elif model == "recall.tisas":
            write_tisas_data(data, seed + 27 + i, md, users=GRAPH_STEPS * SEQ_BATCH)
        elif model == "recall.ensfm":
            write_ensfm_data(data, seed + 27 + i, md, users=20 * SEQ_BATCH)
        else:
            social, rating = mhcn_graph(seed + 27, md)
            write_mhcn_data(data, rating, GRAPH_STEPS * SEQ_BATCH, seed + 27 + i)
        ckpt = os.path.join(work, f"ckpt_{name}")
        cfg = graph_config(model, **{
            **extra, "runner.train_data_dir": data, "runner.test_data_dir": data,
            "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
            "runner.epochs": 2, "runner.print_interval": 5})
        trainer = Trainer(cfg)
        trainer.init_state(seed=seed)
        if label == "recall.mhcn set_graph":
            trainer.model_def.set_graph(social, rating)
        if model.startswith("graph.") and not isinstance(
                trainer.make_dataset(data, SEQ_BATCH), GraphChunkedDataset):
            raise AssertionError(f"{model} did not read through the native engine")
        infer_k1, step_k1 = GRAPH_LAUNCHES.get(model, (1, 1))
        run = run_training(gp, cfg, seed, trainer=trainer, tables=step_k1,
                           eval_tables=infer_k1, min_steps=20)
        run["model"] = label
        if model.startswith("graph."):
            run["dataset"] = "GraphChunkedDataset (native engine)"
        _add_run(out, run)
        out["runs"][label] = run
        trainers[label] = trainer
        emit({"train": run, "card": card})
        gc.collect()
        torch.cuda.empty_cache()

    serve_graph_models(gp, trainers, seed, card, out)
    trainers.clear()
    gc.collect()
    torch.cuda.empty_cache()
    walk_feeds_at_scale(gp, work, seed, card, out, datas)

    for model in ("recall.deepwalk", "graph.gnn", "recall.tisas", "recall.ensfm"):
        name = model.split(".")[1]
        export_dir = os.path.join(work, f"export_{name}")
        t0 = time.perf_counter()
        export_model(graph_config(model, **{"runner.model_init_path": os.path.join(
            work, f"ckpt_{name}", "1")}), export_dir)
        cpu_preds = np.concatenate([p.reshape(-1) for p in run_predict(
            export_dir, datas[model], SEQ_BATCH, device="cpu")[0]])
        _reset(gp)
        served, report = run_predict(export_dir, datas[model], SEQ_BATCH)
        launched = _counts(gp)
        infer_k1 = GRAPH_LAUNCHES.get(model, (1, 1))[0]
        if launched[:2] != (infer_k1 * len(served), 0):
            raise AssertionError(f"{model}: K1, K1b {launched[:2]} for {len(served)} batches")
        _add_launched(out, launched)
        preds = np.concatenate([p.reshape(-1) for p in served])
        err = float(np.abs(preds - cpu_preds).max())
        if not (np.all(np.isfinite(preds)) and np.ptp(preds) > 0 and err <= ZOO_ATOL):
            raise AssertionError(f"{model}: served predictions, card vs CPU max err {err}")
        emit({"predict": {"model": model, "batch_size": SEQ_BATCH, **report,
                          "max_abs_err_vs_cpu": err, "k1_launches": launched[0],
                          "seconds_export_and_predict": time.perf_counter() - t0},
              "card": card})
        shutil.rmtree(export_dir)
    for model in ("recall.tisas", "recall.mind"):
        emit({"profile_train": profile_train(graph_config(model), SEQ_BATCH, seed, iters=5),
              "card": card})
    return out


# the lookups of phases 26 and 27, each one K1 launch (fill mode, the
# gathers from activations in clip mode): (shape, rows, D, N, ids, mode,
# trained: K1b at the shape too); the served batch 1024 is a forward only
GRAPH_SHAPES = (
    ("deepwalk node_embedding, src + positive + 5 negatives", 10312, 16, 32 * 7,
     "uniform", "fill", True),
    ("deepwalk node_embeddings served, B=32", 10312, 16, 32, "uniform", "fill", False),
    ("deepwalk node_embeddings served, B=1024", 10312, 16, 1024, "uniform", "fill", False),
    ("gnn node_embedding, pair nodes + one hop of 5", 10000, 64, 32 * 2 * 6, "uniform",
     "fill", True),
    ("deepwalk_million node_embedding, pair nodes", 10000, 64, 32 * 2, "uniform", "fill",
     True),
    ("mind item_emb, history + target + 128 negatives", 367983, 64, 32 * 149, "uniform",
     "fill", True),
    ("mind user_capsules served, B=32", 367983, 64, 32 * 20, "uniform", "fill", False),
    ("mind user_capsules served, B=1024", 367983, 64, 1024 * 20, "uniform", "fill", False),
    ("tisas item_emb, history + positives + negatives (B=32 served: + 100 candidates)",
     3418, 50, 32 * 150, "uniform", "fill", True),
    ("tisas item_emb, history + 100 candidates, B=1024", 3418, 50, 1024 * 150, "uniform",
     "fill", False),
    ("tisas abs_pos_K/V_emb", 50, 50, 32 * 50, "period 50", "fill", True),
    ("tisas abs_pos_K/V_emb, B=1024", 50, 50, 1024 * 50, "period 50", "fill", False),
    ("tisas time_matrix_K/V_emb", 257, 50, 32 * 50 * 50, "uniform", "fill", True),
    ("tisas time_matrix_K/V_emb, B=1024", 257, 50, 1024 * 50 * 50, "uniform", "fill", False),
    ("ensfm user_feature_emb", 6069, 8, 32, "uniform", "fill", True),
    ("ensfm user_feature_emb served, B=1024", 6069, 8, 1024, "uniform", "fill", False),
    ("ensfm user_bias", 6069, 1, 32, "uniform", "fill", True),
    ("ensfm user_bias served, B=1024", 6069, 1, 1024, "uniform", "fill", False),
    ("ensfm all_item_feature_emb, the catalogue", 3954, 8, 3953, "period 3953", "fill", True),
    ("ensfm item_bias, the catalogue", 3953, 1, 3953, "period 3953", "fill", True),
    ("ensfm positives' rows of q, half of them pads clipped", 3953, 10, 32 * 64, "half last",
     "clip", True),
    ("mhcn users' rows of the user embedding", 64, 50, 32, "uniform", "clip", True),
    ("mhcn positives' + negatives' rows of the item embedding", 64, 50, 64, "uniform",
     "clip", True),
)


@_uncounted
def check_graph_shapes(gp, seed: int, card: str) -> None:
    """Phase 28, before the timing: K1 and K1b at ``GRAPH_SHAPES`` against
    their plain versions on the ids the timing uses first: K1 bitwise, K1b
    rtol 1e-5 and atol 1e-6 times the most adds a row takes (tisas's
    time-matrix rows take about 311 a row at B=32), atomics adding in
    another order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    checks = []
    for name, rows, dim, n, kind, mode, trained in GRAPH_SHAPES:
        table = torch.randn(rows, dim, device="cuda", generator=g)
        ids = _fill_ids(kind, rows, n, g)
        out = gp.gather_pool(table, ids, None, mode=mode)
        ref = gp.gather_pool_plain(table, ids, None, mode=mode)
        check = {"shape": name, "n": n, "dim": dim, "rows": rows, "ids": kind, "mode": mode,
                 "k1_max_abs_err": float((out - ref).abs().max()),
                 "k1_ok": bool(torch.equal(out, ref)), "k1_tolerance": "bitwise"}
        if trained:
            grad = torch.randn(n, dim, device="cuda", generator=g)
            err, ok, tol, adds = k1b_check(gp, grad, ids, None, rows, torch.float32, mode)
            check.update(most_adds_per_row=adds, k1b_max_abs_err=err, k1b_tolerance=tol,
                         k1b_ok=ok)
        torch.cuda.synchronize()
        checks.append(check)
        del table, ids, out, ref
        if not (check["k1_ok"] and check.get("k1b_ok", True)):
            raise AssertionError(f"a kernel disagrees with its plain version: {check}")
    emit({"graph_kernel_checks": checks, "card": card})


# -- the tree family, a2c and the movie demo (phases 29-32) -----------------
TREE_ITEMS, TREE_CATEGORIES = 65_536, 64  # by category: 16 levels, 131,071 nodes
TREE_STEPS = 300  # steps an epoch at the config's batch 32
TREE_EVAL_STEPS = 10
TREE_SERVE = (SEQ_BATCH, 1024)
TREE_SERVE_CALLS = 101  # a warm-up and 100 timed retrievals a batch size
TREE_PROFILE_CALLS = 5  # then profiled: the profiler's cost grows with the kernels it records
TREE_BEAM, TREE_TOPK = 20, 10
JTM_ITEMS, JTM_STEPS = 4_096, 64  # the JTM run's tree (12 levels) and steps a round
A2C_FRAMES, A2C_LOG_EVERY = 20_000, 2_000
# MovieLens-1M's shape: users, movies, genres, words a title at most
MOVIE_USERS, MOVIE_MOVIES, MOVIE_GENRES = 6_040, 3_883, 18
MOVIE_WORDS = 5_000  # the titles' vocabulary
MOVIE_STEPS = 150  # steps an epoch at batch 32
MOVIE_SERVE_CALLS = 301  # a warm-up and 300 timed recommendations (and HTTP calls)
MOVIE_TWIN_UIDS = 24  # the users whose recommendations the CPU twin answers too


def tree_config(name: str = "tdm", **extra):
    """``configs/treebased/<name>/config.yaml`` with ``extra`` flat keys."""
    return slice_config(f"treebased.{name}", **extra)


def category_tree(seed: int, items: int, categories: int):
    """A ``TreeIndex`` built by category over item ids 1..items, each
    category ``items / categories`` seeded items: every category fills one
    subtree.  Returns (tree, category of each item id, 0 unused)."""
    from paddlerec_tpu_torch.models.treebased.tree import TreeIndex

    rng = np.random.RandomState(seed)
    cats = np.zeros(items + 1, np.int64)
    cats[1:] = rng.permutation(items) % categories
    return TreeIndex.build_by_category(np.arange(1, items + 1), cats[1:]), cats


def tdm_rows(cats, rows: int, hist_len: int, seed: int):
    """(histories (rows, hist_len) of item ids, targets, categories): each
    row's history and target from one category of ``cats``, its items drawn
    by a Zipf law of exponent 1.2 over the category's (a few popular items
    take most of the clicks); one history item in 20 an id the tree does not
    hold (code 0 under mask 0)."""
    rng = np.random.RandomState(seed)
    items = len(cats) - 1
    by_cat = [np.flatnonzero(cats[1:] == c) + 1 for c in range(int(cats[1:].max()) + 1)]
    law = np.cumsum(1.0 / np.arange(1, len(by_cat[0]) + 1) ** 1.2)
    law /= law[-1]
    row_cat = rng.randint(len(by_cat), size=rows)
    members = np.stack([by_cat[c] for c in row_cat])  # (rows, items a category)
    picks = np.minimum(np.searchsorted(law, rng.rand(rows, hist_len + 1)), law.size - 1)
    drawn = np.take_along_axis(members, picks, axis=1)
    hist, targets = drawn[:, :hist_len], drawn[:, hist_len]
    hist[rng.rand(rows, hist_len) < 0.05] = items + 1 + rng.randint(1000)
    return hist, targets, row_cat


def write_tdm_data(data_dir: str, cats, rows: int, hist_len: int, seed: int) -> None:
    """``TDMDataset`` lines ``hist ... | target`` from ``tdm_rows``."""
    hist, targets, _ = tdm_rows(cats, rows, hist_len, seed)
    _write_lines(data_dir, [f"{_ids(h)} | {t}" for h, t in zip(hist, targets)])


def tdm_histories(tree, cats, rows: int, hist_len: int, seed: int, device):
    """Retrieval inputs of ``tdm_rows``: (hist codes, hist mask) on
    ``device`` and the rows' categories."""
    hist, _, row_cat = tdm_rows(cats, rows, hist_len, seed)
    code = dict(zip(tree.item_ids.tolist(), tree.codes.tolist()))
    codes = np.vectorize(lambda i: code.get(int(i), 0), otypes=[np.int64])(hist)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy((codes > 0).astype(np.float32)).to(device), row_cat)


def _twins(cfg, seed: int, prepare=None):
    """(card trainer, CPU trainer) of ``cfg`` holding the CPU twin's initial
    parameters; ``prepare(model_def)`` runs on each model before its
    parameters are made (a tree set)."""
    from paddlerec_tpu_torch.train.trainer import Trainer

    host, chip = Trainer(cfg, device="cpu"), Trainer(cfg)
    for trainer in (host, chip):
        if prepare is not None:
            prepare(trainer.model_def)
        trainer.init_state(seed=seed)
    chip.state.module.load_state_dict(host.state.module.state_dict())
    return chip, host


def _tdm_output(md, module, batch) -> np.ndarray:
    with torch.no_grad():
        return md.infer_forward(module, batch)["predictions"].cpu().numpy()


def _retrievals(md, module, hist, mask, calls: int) -> tuple:
    """``calls`` retrievals of the same rows, each ended by a synchronise:
    (the item lists, p50 and p99 wall ms of all but the first)."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        got = md.retrieve(module, hist, mask, topk=TREE_TOPK, beam=TREE_BEAM)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    timed = np.array(times[1:])
    return got, float(np.percentile(timed, 50)), float(np.percentile(timed, 99))


def tree_paths(gp, work: str, seed: int, card: str) -> dict:
    """Phase 29, the tree family at the widths of
    ``configs/treebased/tdm/config.yaml`` (``node_emb_size`` 24, the 69 ids
    of the default ``fea_groups``, 4 negatives a level, batch 32) on a tree
    of ``TREE_ITEMS`` seeded items in ``TREE_CATEGORIES`` categories, built
    by category (16 levels, 131,071 nodes), rows whose history and target
    come from one category:
      * a module on the card and its CPU twin from one seed: a forward and
        three train steps (atol 1e-5), one K1 a forward, one K1 and one K1b
        a step;
      * ``Trainer.train()`` for two epochs of ``TREE_STEPS`` steps, the loss
        falling, and ``evaluate()`` from the checkpoint (AUC above 0.5);
      * ``retrieve`` (beam ``TREE_BEAM``, top ``TREE_TOPK``) at batch 32 and
        1024: the item lists equal to the CPU twin's on the same trained
        parameters, the recall of the history's category above chance, then
        p50/p99 of ``TREE_SERVE_CALLS - 1`` timed calls, then
        ``TREE_PROFILE_CALLS`` more under ``profile_calls`` (device time and
        idle share a call); one K1 a level and one for the final rescore;
      * JTM through ``python -m paddlerec_tpu_torch.tools.jtm`` in-process on
        ``configs/treebased/jtm/config.yaml`` (2 rounds, gap 3, 4 samples)
        with a tree of ``JTM_ITEMS`` items: each round's tree a valid
        permutation of the items onto its leaves."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.models.treebased.tree import TreeIndex
    from paddlerec_tpu_torch.tools import jtm as jtm_cli

    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}}
    t0 = time.perf_counter()
    tree, cats = category_tree(seed + 29, TREE_ITEMS, TREE_CATEGORIES)
    build_s = time.perf_counter() - t0
    if (tree.max_level, tree.total_nodes) != (16, 131_071):
        raise AssertionError(f"tree of {tree.max_level} levels, {tree.total_nodes} nodes")
    data, test = os.path.join(work, "tdm_train"), os.path.join(work, "tdm_test")
    ckpt = os.path.join(work, "ckpt_tdm")
    cfg = tree_config(**{"runner.train_data_dir": data, "runner.test_data_dir": test,
                         "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt,
                         "runner.epochs": 2, "runner.print_interval": 10})
    chip, host = _twins(cfg, seed, prepare=lambda md: md.set_tree(tree))
    md = chip.model_def
    hist_len = sum(md.fea_groups)
    write_tdm_data(data, cats, TREE_STEPS * SEQ_BATCH, hist_len, seed + 29)
    write_tdm_data(test, cats, TREE_EVAL_STEPS * SEQ_BATCH, hist_len, seed + 30)
    t0 = time.perf_counter()
    batches = list(itertools.islice(iter(md.make_dataset(data, SEQ_BATCH)), 4))
    twin, ((f1, f1b, _, _), (s1, s1b, _, _)) = _twin_steps(gp, chip, host, batches,
                                                            _tdm_output)
    twin.update(model="treebased.tdm", seconds=time.perf_counter() - t0, tree_build_s=build_s,
                units_per_row=batches[0]["unit_codes"].shape[1], k1_per_forward=f1,
                k1b_per_step=s1b // 3)
    if not twin["ok"] or (f1, f1b, s1, s1b) != (1, 0, 3, 3):
        raise AssertionError(f"treebased.tdm card against CPU: {twin}, K1, K1b "
                             f"{(f1, f1b, s1, s1b)}")
    out["k1"] += f1 + s1
    out["k1b"] += s1b
    emit({"tree_twin": twin, "card": card})
    # train a fresh module on the card alone
    del host
    chip.init_state(seed=seed)
    run = run_training(gp, cfg, seed, trainer=chip, min_steps=2 * TREE_STEPS)
    run["model"] = "treebased.tdm"
    _add_run(out, run)
    emit({"train": run, "card": card})

    twin_module = md.make_module(device="cpu")
    twin_module.load_state_dict(chip.state.module.state_dict())
    for batch in TREE_SERVE:
        hist, mask, row_cat = tdm_histories(tree, cats, batch, hist_len, seed + 31,
                                            chip.device)
        with torch.inference_mode():
            want = md.retrieve(twin_module, hist.cpu(), mask.cpu(), topk=TREE_TOPK,
                               beam=TREE_BEAM)
            _reset(gp)
            got, p50, p99 = _retrievals(md, chip.state.module, hist, mask, TREE_SERVE_CALLS)
            prof = profile_calls(lambda: md.retrieve(chip.state.module, hist, mask,
                                                     topk=TREE_TOPK, beam=TREE_BEAM),
                                 TREE_PROFILE_CALLS, "call")
        launched = _counts(gp)
        per_call = len(tree.beam_layers(TREE_BEAM)) + 1
        if launched[:2] != (per_call * (TREE_SERVE_CALLS + TREE_PROFILE_CALLS), 0):
            raise AssertionError(f"retrieve at {batch}: K1, K1b {launched[:2]}")
        _add_launched(out, launched)
        differ = sum(a != b for a, b in zip(got, want))
        hits = np.array([np.mean([cats[i] == c for i in items])
                         for items, c in zip(got, row_cat)])
        result = {"batch_size": batch, "beam": TREE_BEAM, "topk": TREE_TOPK,
                  "calls": TREE_SERVE_CALLS - 1, "p50_ms": p50, "p99_ms": p99,
                  "k1_per_call": per_call, "rows_differing_from_cpu": differ,
                  "recall_of_the_category": float(hits.mean()),
                  "chance": 1.0 / TREE_CATEGORIES,
                  "items_per_row": float(np.mean([len(r) for r in got])),
                  "profile": {"calls": TREE_PROFILE_CALLS, **prof}}
        emit({"tdm_retrieve": result, "card": card})
        if differ or not hits.mean() > 1.0 / TREE_CATEGORIES:
            raise AssertionError(f"retrieve at {batch}: {result}")
    del chip, twin_module

    t0 = time.perf_counter()
    jtm_tree, jtm_cats = category_tree(seed + 32, JTM_ITEMS, TREE_CATEGORIES)
    tree_path = os.path.join(work, "jtm_tree.npz")
    jtm_tree.save(tree_path)
    jtm_data, jtm_out = os.path.join(work, "jtm_train"), os.path.join(work, "jtm_out")
    jtm_cfg = tree_config("jtm")
    jtm_hist = sum(int(x) for x in str(jtm_cfg.hyper("fea_groups")).split(","))
    write_tdm_data(jtm_data, jtm_cats, JTM_STEPS * SEQ_BATCH, jtm_hist, seed + 33)
    _reset(gp)
    metrics = jtm_cli.main([
        "-m", os.path.join(ROOT, "configs", "treebased", "jtm", "config.yaml"),
        "-o", f"runner.train_data_dir={jtm_data}", f"runner.model_save_path={jtm_out}",
        f"hyper_parameters.tree_path={tree_path}"])
    launched = _counts(gp)
    rounds = int(jtm_cfg.runner("jtm_rounds"))
    moved, before = [], jtm_tree
    for r in range(rounds):
        new = TreeIndex.load(os.path.join(jtm_out, f"jtm_tree_round{r}.npz"))
        valid = (sorted(new.item_ids.tolist()) == list(range(1, JTM_ITEMS + 1))
                 and len(set(new.codes.tolist())) == JTM_ITEMS
                 and {new._level(int(c)) for c in new.codes} == {jtm_tree.max_level})
        if not valid:
            raise AssertionError(f"JTM round {r}: not a permutation of the items")
        old = dict(zip(before.item_ids.tolist(), before.codes.tolist()))
        moved.append(sum(old[i] != c for i, c in zip(new.item_ids.tolist(),
                                                     new.codes.tolist())))
        before = new
    steps = rounds * JTM_STEPS
    if launched[1] != steps or launched[0] <= steps or not np.isfinite(metrics["auc"]):
        raise AssertionError(f"JTM: {steps} steps launched K1, K1b {launched[:2]}")
    _add_launched(out, launched)
    emit({"jtm": {"items": JTM_ITEMS, "levels": jtm_tree.max_level, "rounds": rounds,
                  "gap": int(jtm_cfg.hyper("jtm_gap")),
                  "samples": int(jtm_cfg.hyper("jtm_sample_nums")), "steps": steps,
                  "train_auc_last_round": metrics["auc"],
                  "items_moved_each_round": moved, "k1_launches": launched[0],
                  "k1b_launches": launched[1], "seconds": time.perf_counter() - t0},
          "card": card})
    return out


def a2c_phase(seed: int, card: str) -> None:
    """Phase 30, rl.a2c at the ModelDef's defaults (16 environments, hidden
    256, 5 steps, γ 0.99, lr 1e-3; ``configs/rl/a2c/config.yaml``), dense
    torch on the card (no lookup, so no K1 or K1b):
      * one ``rollout_loss`` and every gradient, card against a CPU twin of
        the same parameters and state, fed the same actions and reset states
        (atol 1e-5);
      * the untrained policy's greedy return, then ``train()`` for
        ``A2C_FRAMES`` frames, the greedy return evaluated every
        ``A2C_LOG_EVERY``: the history printed with frames/s, and the last
        return above the first (the untrained policy's)."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.models.rl.a2c.model import EnvState

    md = load_model_def(slice_config("rl.a2c"))
    device = torch.device("cuda")
    module = md.make_module(device=device,
                            generator=torch.Generator(device=device).manual_seed(seed))
    twin = md.make_module(device="cpu")
    twin.load_state_dict(module.state_dict())
    rng = np.random.RandomState(seed + 30)
    obs = rng.uniform(-0.05, 0.05, (md.num_envs, 4)).astype(np.float32)
    steps = rng.randint(0, 200, md.num_envs).astype(np.int32)
    steps[:3] = 197  # episodes that end inside the rollout
    actions = [torch.from_numpy(rng.randint(0, 2, md.num_envs)) for _ in range(md.num_steps)]
    fresh = [torch.from_numpy(rng.uniform(-0.05, 0.05, (md.num_envs, 4)).astype(np.float32))
             for _ in range(md.num_steps)]
    losses, grads = {}, {}
    for name, m, dev in (("cuda", module, device), ("cpu", twin, torch.device("cpu"))):
        state = EnvState(torch.from_numpy(obs).to(dev), torch.from_numpy(steps).to(dev), None)
        loss, _ = md.rollout_loss(m, state, actions=[a.to(dev) for a in actions],
                                  fresh=[f.to(dev) for f in fresh])
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    grad_err = max(float((grads["cuda"][k] - grads["cpu"][k]).abs().max()) for k in grads["cpu"])
    loss_err = abs(losses["cuda"] - losses["cpu"])
    if not (loss_err <= ZOO_ATOL and grad_err <= ZOO_ATOL and np.isfinite(losses["cuda"])):
        raise AssertionError(f"a2c rollout card vs CPU: loss {losses}, gradients {grad_err}")
    untrained = md.evaluate_policy(module, torch.Generator(device=device).manual_seed(seed))
    del module, twin
    t0 = time.perf_counter()
    trained, history = md.train(total_frames=A2C_FRAMES, seed=seed, log_every=A2C_LOG_EVERY)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    history = [untrained] + history
    result = {"envs": md.num_envs, "hidden": md.hidden, "steps": md.num_steps,
              "frames": A2C_FRAMES, "log_every": A2C_LOG_EVERY,
              "greedy_returns_from_frame_0": history, "seconds": seconds,
              "frames_per_s_with_evaluations": A2C_FRAMES / seconds,
              "rollout_loss_cuda": losses["cuda"], "max_abs_err_loss": loss_err,
              "max_abs_err_gradients": grad_err, "atol": ZOO_ATOL}
    emit({"a2c": result, "card": card})
    if not (len(history) == 1 + A2C_FRAMES // A2C_LOG_EVERY and history[-1] > history[0]):
        raise AssertionError(f"a2c did not learn: {history}")


MOVIE_OFFSETS = {"uid": 0, "gender": 6_041, "age": 6_043, "occupation": 6_050,
                 "movie": 10_000, "word": 20_000, "genre": 30_000}


def movie_catalogue(seed: int) -> dict:
    """MovieLens-1M's shape in the shared vocabulary of 600,000 ids:
    ``MOVIE_USERS`` users (uid, gender of 2, age of 7 buckets, occupation of
    21), ``MOVIE_MOVIES`` movies (id, a title of 1-8 of ``MOVIE_WORDS`` words,
    1-4 of ``MOVIE_GENRES`` genres, slots past them id 0 under mask 0), each
    field's ids in a range of its own (``MOVIE_OFFSETS``).  The planted
    taste: a user's favourite genre follows gender and age."""
    o, rng = MOVIE_OFFSETS, np.random.RandomState(seed)
    gender, age = rng.randint(2, size=MOVIE_USERS), rng.randint(7, size=MOVIE_USERS)
    users = np.stack([o["uid"] + 1 + np.arange(MOVIE_USERS), o["gender"] + gender,
                      o["age"] + age, o["occupation"] + rng.randint(21, size=MOVIE_USERS)],
                     1).astype(np.int64)
    words = rng.randint(1, 9, MOVIE_MOVIES)
    title_mask = (np.arange(8)[None] < words[:, None]).astype(np.float32)
    title = (o["word"] + 1 + rng.randint(MOVIE_WORDS, size=(MOVIE_MOVIES, 8))) * title_mask
    genre_sets = [rng.choice(MOVIE_GENRES, rng.randint(1, 5), replace=False)
                  for _ in range(MOVIE_MOVIES)]
    genres = np.zeros((MOVIE_MOVIES, 4), np.int64)
    genre_mask = np.zeros((MOVIE_MOVIES, 4), np.float32)
    for i, g in enumerate(genre_sets):
        genres[i, :len(g)] = o["genre"] + 1 + g
        genre_mask[i, :len(g)] = 1.0
    return {"users": users, "favourite": (gender * 7 + age) % MOVIE_GENRES,
            "movie_id": o["movie"] + 1 + np.arange(MOVIE_MOVIES), "title": title.astype(np.int64),
            "title_mask": title_mask, "genres": genres, "genre_mask": genre_mask,
            "genre_sets": genre_sets}


def movie_batches(cat: dict, steps: int, seed: int) -> list:
    """``steps`` batches of 32 planted ratings: 5 where the movie holds the
    user's favourite genre, else 1, plus noise, rounded into 1-5; half the
    pairs drawn from the favourite genre's movies."""
    rng = np.random.RandomState(seed)
    n = steps * SEQ_BATCH
    u = rng.randint(MOVIE_USERS, size=n)
    liked = [np.flatnonzero([g in s for s in cat["genre_sets"]]) for g in range(MOVIE_GENRES)]
    m = np.where(rng.rand(n) < 0.5, rng.randint(MOVIE_MOVIES, size=n),
                 [rng.choice(liked[cat["favourite"][x]]) for x in u])
    fav = np.array([cat["favourite"][x] in cat["genre_sets"][y] for x, y in zip(u, m)])
    label = np.clip(np.rint(np.where(fav, 5.0, 1.0) + rng.randn(n) * 0.5), 1, 5)
    rows = {"user_sparse": cat["users"][u], "movie_id": cat["movie_id"][m],
            "title": cat["title"][m], "genres": cat["genres"][m],
            "title_mask": cat["title_mask"][m], "genre_mask": cat["genre_mask"][m],
            "label": label.astype(np.float32)}
    return [{k: v[i * SEQ_BATCH:(i + 1) * SEQ_BATCH] for k, v in rows.items()}
            for i in range(steps)]


def _movie_output(md, module, batch) -> np.ndarray:
    with torch.no_grad():
        return md.infer_forward(module, batch)["predictions"].cpu().numpy()


def movie_feeds(cat: dict, rows: str) -> dict:
    """The model inputs of every user (``rows="users"``, the movie fields
    those of the first movie) or of every movie (the user fields those of
    the first user)."""
    n = MOVIE_USERS if rows == "users" else MOVIE_MOVIES
    pick = {"users": (np.arange(n), np.zeros(n, np.int64)),
            "movies": (np.zeros(n, np.int64), np.arange(n))}[rows]
    u, m = pick
    return {"user_sparse": cat["users"][u], "movie_id": cat["movie_id"][m],
            "title": cat["title"][m], "genres": cat["genres"][m],
            "title_mask": cat["title_mask"][m], "genre_mask": cat["genre_mask"][m],
            "label": np.zeros(n, np.float32)}


def movie_app(cat: dict, recall_md, recall_module, rank_md, rank_module, device):
    """The five services over the catalogue: um and cm from ``cat``, every
    user's and movie's vector exported by ``recall_module`` into a cosine
    ``VectorIndex`` on ``device``, rank by ``rank_module``."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.serving import movie_recommender as rec
    from paddlerec_tpu_torch.serving.vector_index import VectorIndex

    with torch.inference_mode():
        users = recall_md.user_vector(recall_module, to_tensors(movie_feeds(cat, "users"),
                                                                device)).cpu().numpy()
        movies = recall_md.movie_vector(recall_module, to_tensors(movie_feeds(cat, "movies"),
                                                                  device)).cpu().numpy()
    index = VectorIndex("cosine", device=device)
    index.insert(movies, ids=cat["movie_id"].tolist())
    um, cm = rec.UserModelService(), rec.ContentModelService()
    for i in range(MOVIE_USERS):
        um.put(i + 1, {"user_sparse": cat["users"][i]})
    for j, mid in enumerate(cat["movie_id"].tolist()):
        cm.put(mid, {"movie_id": mid, **{k: cat[k][j] for k in (
            "title", "genres", "title_mask", "genre_mask")}})
    store = {i + 1: users[i] for i in range(MOVIE_USERS)}
    return rec.ApplicationServer(um, cm, rec.RecallService(index, store),
                                 rec.RankService(rank_md, rank_module))


def movie_paths(gp, seed: int, card: str) -> dict:
    """Phase 31, the movie demo at the full width of
    ``configs/demo/movie_{recall,rank}/config.yaml`` (vocab 600,000, dim 9,
    towers [512, 256, 128, 32], batch 32) on rows of MovieLens-1M's shape
    written from ``seed`` (``movie_catalogue``; planted ratings):
      * each model on the card and its CPU twin from one seed: a forward and
        three train steps (atol 1e-5), three K1 a forward (the user fields
        and the movie id in one lookup, the title's and the genres' masked
        bags), three K1 and three K1b a step;
      * each trained with ``Trainer.train_step`` for two epochs of
        ``MOVIE_STEPS`` in-memory batches: the second epoch's mean loss
        below the first's;
      * every user's and movie's vector exported into a cosine
        ``VectorIndex``; the five services (um, cm, recall, rank, as) and
        ``serve_http``: ``recommend`` for ``MOVIE_TWIN_UIDS`` users equal to
        a CPU twin's services on the same parameters (movie ids in order,
        scores atol 1e-5), the share of the favourite genre in the top 10
        above its share of the catalogue, and p50/p99 of ``recommend`` and
        of ``GET /as/recommend`` over ``MOVIE_SERVE_CALLS - 1`` calls each,
        the HTTP answer equal to ``recommend``'s."""
    import urllib.request

    from paddlerec_tpu_torch.core.device import to_tensors

    out = {"k1": 0, "k1b": 0, "k1_by_dim": {}, "k1b_by_dim": {}}
    cat = movie_catalogue(seed + 31)
    train = movie_batches(cat, MOVIE_STEPS, seed + 32)
    trained = {}
    for model in ("demo.movie_recall", "demo.movie_rank"):
        cfg = slice_config(model)
        chip, host = _twins(cfg, seed)
        t0 = time.perf_counter()
        twin, ((f1, f1b, _, _), (s1, s1b, _, _)) = _twin_steps(gp, chip, host, train[:4],
                                                                _movie_output)
        twin.update(model=model, seconds=time.perf_counter() - t0, k1_per_forward=f1,
                    k1b_per_step=s1b // 3,
                    parameters=sum(p.numel() for p in chip.state.module.parameters()))
        emit({"movie_twin": twin, "card": card})
        if not twin["ok"] or (f1, f1b, s1, s1b) != (3, 0, 9, 9):
            raise AssertionError(f"{model} card against CPU: {twin}, K1, K1b "
                                 f"{(f1, f1b, s1, s1b)}")
        out["k1"] += f1 + s1
        out["k1b"] += s1b
        del host
        chip.init_state(seed=seed)
        _reset(gp)
        epochs, ms = [], {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            losses = []
            for b in train:
                ms, loss = chip.train_step(to_tensors(b, chip.device), ms)
                losses.append(loss)
            epochs.append(float(torch.stack(losses).mean()))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = _counts(gp)
        steps = 2 * len(train)
        if launched[:2] != (3 * steps, 3 * steps) or not epochs[1] < epochs[0]:
            raise AssertionError(f"{model}: epoch losses {epochs}, K1, K1b {launched[:2]}")
        _add_launched(out, launched)
        emit({"movie_train": {"model": model, "steps": steps, "batch_size": SEQ_BATCH,
                              "epoch_mean_losses": epochs,
                              "examples_per_s": steps * SEQ_BATCH / seconds,
                              "k1_launches": launched[0], "k1b_launches": launched[1]},
              "card": card})
        trained[model] = chip
    recall, rank = trained["demo.movie_recall"], trained["demo.movie_rank"]
    _reset(gp)
    t0 = time.perf_counter()
    app = movie_app(cat, recall.model_def, recall.state.module, rank.model_def,
                    rank.state.module, recall.device)
    export_s = time.perf_counter() - t0
    twins = {}
    for name, trainer in (("recall", recall), ("rank", rank)):
        twins[name] = trainer.model_def.make_module(device="cpu")
        twins[name].load_state_dict(trainer.state.module.state_dict())
    cpu_app = movie_app(cat, recall.model_def, twins["recall"], rank.model_def,
                        twins["rank"], torch.device("cpu"))
    uids = np.random.RandomState(seed + 33).randint(1, MOVIE_USERS + 1, MOVIE_SERVE_CALLS)
    score_err, liked, base = 0.0, [], []
    for uid in uids[:MOVIE_TWIN_UIDS]:
        got, want = app.recommend(int(uid)), cpu_app.recommend(int(uid))
        if [r["movie_id"] for r in got] != [r["movie_id"] for r in want] or len(got) != 10:
            raise AssertionError(f"uid {uid}: card {got}, CPU {want}")
        score_err = max(score_err, max(abs(a["score"] - b["score"]) for a, b in zip(got, want)))
        fav = cat["favourite"][uid - 1]
        liked.append(np.mean([fav in cat["genre_sets"][r["movie_id"] - MOVIE_OFFSETS["movie"]
                                                      - 1] for r in got]))
        base.append(np.mean([fav in s for s in cat["genre_sets"]]))
    served = {"export_s": export_s, "twin_uids": MOVIE_TWIN_UIDS,
              "max_abs_err_scores_vs_cpu": score_err,
              "favourite_genre_share_top10": float(np.mean(liked)),
              "favourite_genre_share_catalogue": float(np.mean(base))}
    if not (score_err <= ZOO_ATOL and np.mean(liked) > np.mean(base)):
        raise AssertionError(f"the movie services: {served}")
    server = app.serve_http(port=0)
    try:
        port = server.server_address[1]
        for label, call in (
                ("recommend", lambda uid: app.recommend(int(uid))),
                ("http", lambda uid: json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/as/recommend?uid={uid}&topk=10",
                    timeout=30).read()))):
            times, answers = [], []
            for uid in uids:
                t0 = time.perf_counter()
                answers.append(call(uid))
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            timed = np.array(times[1:])
            served[f"{label}_p50_ms"] = float(np.percentile(timed, 50))
            served[f"{label}_p99_ms"] = float(np.percentile(timed, 99))
            if label == "http" and any(a != {"uid": int(u), "items": app.recommend(int(u))}
                                       for a, u in zip(answers[:MOVIE_TWIN_UIDS], uids)):
                raise AssertionError("an HTTP answer differs from recommend()")
    finally:
        server.shutdown()
        server.server_close()
    launched = _counts(gp)
    calls = 2 * MOVIE_SERVE_CALLS + 2 * len(uids[:MOVIE_TWIN_UIDS])  # timed, then compared
    if launched[:2] != (3 * 2 + 3 * calls, 0):
        raise AssertionError(f"the movie services launched K1, K1b {launched[:2]}")
    _add_launched(out, launched)
    served.update(calls=MOVIE_SERVE_CALLS - 1, k1_launches=launched[0])
    emit({"movie_services": served, "card": card})
    return out


# the lookups of phases 29-31, each one K1 launch in fill mode (the movie
# bags masked): (shape, rows, D, N, L, trained: K1b at the shape too).  TDM's
# N is B·(69 history ids + the units or candidates); a retrieval reads 32
# nodes at its first level, 40 children at each of the 11 levels below and
# rescores the last beam of 20.  K1b keys a bag by its count N, not its L:
# the movie's two bags of 32 share one key.
_TDM_HIST, _JTM_HIST = 69, 20
SLICE_SHAPES = {
    "tree": tuple(
        [("tdm node_emb, history + 16 levels × 5 units, B=32", 131071, 24,
          32 * (_TDM_HIST + 80), 1, True)]
        + [(f"tdm retrieve, {what}, B={b}", 131071, 24, b * (_TDM_HIST + c), 1, False)
           for b in TREE_SERVE
           for what, c in (("first level (32 nodes)", 32), ("a level (40 children)", 40),
                           ("final rescore (20)", 20))]
        + [("jtm node_emb, history + 12 levels × 5 units, B=32", 8191, 24,
            32 * (_JTM_HIST + 60), 1, True),
           ("jtm scorer, 256 items × 4 samples × (20 + 256 codes)", 8191, 24,
            1024 * (_JTM_HIST + 256), 1, False)]),
    "movie": tuple(
        [("movie SparseFeatFactors, 4 user fields + movie id, B=32", 600000, 9, 160, 1, True),
         ("movie title bags (L=8), B=32", 600000, 9, 32, 8, True),
         ("movie genre bags (L=4), B=32", 600000, 9, 32, 4, True)]
        + [(f"movie {what}, {label}", 600000, 9, n * mult, pool, False)
           for label, n in (("6,040 users exported", MOVIE_USERS),
                            ("3,883 movies exported", MOVIE_MOVIES),
                            ("rank served, padded to 64", 64))
           for what, mult, pool in (("fields + movie id", 5, 1), ("title bags", 1, 8),
                                    ("genre bags", 1, 4))]),
}


class PhaseClock:
    """Seconds of each phase of a run, from the end of the one before.  Each
    lap prints its line as the phase ends, so that a run cut short still
    shows where it was."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        emit({"phase": name, "seconds": self.seconds[name], "total_s": now - self.start})

    def line(self, card: str) -> dict:
        return {"phase_seconds": self.seconds, "total_s": self.last - self.start,
                "card": card}


def tree_rl_demo(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 29-32: the tree family, a2c and the movie demo, then phase 32,
    K1 and K1b at ``SLICE_SHAPES``, each checked against its plain version
    and timed (``time_k1_shapes``, ``time_k1b_shapes``).  Each shape's
    launches are those its key (K1: rows, D, dtype, N, L; K1b: rows, D,
    dtype, N) counted at the launch over the phases: every launch of theirs
    is at a shape, and every shape has launches.  Returns (K1 cases, K1b
    cases, K1 launches, K1b launches)."""
    k1_before = collections.Counter(gp.gather_pool.launches_by_shape)
    k1b_before = collections.Counter(gp.gather_pool_bwd.launches_by_shape)

    def lap(phase: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap(phase)

    tree = tree_paths(gp, work, seed, card)
    lap("29 tree")
    a2c_phase(seed, card)  # no lookup, so no K1 or K1b
    lap("30 a2c")
    movie = movie_paths(gp, seed, card)
    lap("31 movie")
    totals = {k: tree[k] + movie[k] for k in ("k1", "k1b")}
    k1_by, k1b_by = (collections.Counter(c) for c in (gp.gather_pool.launches_by_shape,
                                                       gp.gather_pool_bwd.launches_by_shape))
    k1_by.subtract(k1_before)
    k1b_by.subtract(k1b_before)
    k1_by, k1b_by = +k1_by, +k1b_by
    k1_cases = time_k1_shapes(gp, sum((k1_shapes(g) for g in SLICE_SHAPES), ()), seed + 32)
    k1b_cases = time_k1b_shapes(gp, sum((k1b_shapes(g) for g in SLICE_SHAPES), ()), seed + 32)
    for case in k1_cases:
        case["launches"] = k1_by.get(
            (case["rows"], case["dim"], case["dtype"], case["n"], case["pool"]), 0)
    keys = set()
    for case in k1b_cases:
        key = (case["rows"], case["dim"], case["dtype"], case["n"])
        case["launches"] = k1b_by.get(key, 0)  # the movie's two bags of 32 share a key
        keys.add(key)
    if (sum(c["launches"] for c in k1_cases) != totals["k1"]
            or sum(k1_by.values()) != totals["k1"]
            or not all(c["launches"] > 0 for c in k1_cases)):
        raise AssertionError(f"phases 29-31 launched K1 {totals['k1']} times, by shape "
                             f"{dict(k1_by)}")
    if (sum(k1b_by.values()) != totals["k1b"] or set(k1b_by) - keys
            or not all(c["launches"] > 0 for c in k1b_cases)):
        raise AssertionError(f"phases 29-31 launched K1b {totals['k1b']} times, by shape "
                             f"{dict(k1b_by)}")
    clock.lap("32 K1/K1b at the new shapes")
    return k1_cases, k1b_cases, totals["k1"], totals["k1b"]


# -- phases 33-36: the online day/pass loop and the cube KV store ------------
SLOT_DNN = os.path.join(ROOT, "configs", "rank", "slot_dnn", "config.yaml")
DIN = os.path.join(ROOT, "configs", "rank", "din", "config.yaml")
ONLINE_DAY = "20240101"
ONLINE_DONE = "to.hadoop.done"  # the producer's data donefile in each pass directory
ONLINE_SPLIT = 360  # minutes a pass: four passes a day (slot_dnn, the 10^8 run)
ONLINE_ROWS = 1024  # slot_dnn's rows a pass: 32 steps of its batch 32
BIG_ONLINE_BATCHES = 3  # config_bigdata.yaml's batches of 8192 a pass
DIN_ONLINE_ROWS = 512  # din's rows a pass: 16 steps of its batch 32
# delete_threshold: a row shown once in the day (decayed to 0.98) is evicted
# at the day's end, a row shown twice (1.96) stays
ONLINE_EVICT = 1.5
NEVER_SEEN = 1024  # keys past the table, which no base or delta holds


def write_online_day(root: str, split: int, write, seed: int) -> list:
    """One day of pass directories ``<root>/<day>/<HHMM>`` (the schedule of
    ``get_online_pass_interval``), each written by ``write(dir, seed)`` and
    then marked ready by an empty data donefile, as a producer does."""
    from paddlerec_tpu_torch.train.online import get_online_pass_interval

    dirs = []
    for p, (sub,) in enumerate(get_online_pass_interval(split, 1)):
        d = os.path.join(root, ONLINE_DAY, sub)
        write(d, seed + p)
        open(os.path.join(d, ONLINE_DONE), "w").close()
        dirs.append(d)
    return dirs


def online_config(path: str, data: str, out: str, **extra):
    """A config file's keys with the online loop's settings."""
    from paddlerec_tpu_torch.core.config import Config, load_config

    flat = dict(load_config(path).to_dict())
    flat.update({
        "runner.train_data_dir": data, "runner.model_save_path": out,
        "runner.days": ONLINE_DAY, "runner.split_per_pass": 1,
        "runner.data_donefile": ONLINE_DONE, "runner.save_delta_frequency": 1,
        "runner.delta_cube_shards": 2, "runner.print_interval": 1000,
        "table_parameters.delete_threshold": ONLINE_EVICT,
    })
    flat.update(extra)
    return Config(flat)


def _overrides(cfg) -> list:
    """``-o`` arguments giving a config's keys (lists and None as Python
    literals, which the parser reads back)."""
    return [f"{k}={v!r}" if isinstance(v, list) or v is None else f"{k}={v}"
            for k, v in cfg.to_dict().items() if k not in ("config_dir", "runner.model")]


def _launches(before: tuple) -> tuple:
    """K1's and K1b's launches by shape since ``before`` (``_counted()``)."""
    from paddlerec_tpu_torch.ops import gather_pool as gp

    out = []
    for counter, old in zip((gp.gather_pool.launches_by_shape,
                             gp.gather_pool_bwd.launches_by_shape), before):
        diff = collections.Counter(counter)
        diff.subtract(old)
        out.append(+diff)
    return tuple(out)


def _counted() -> tuple:
    from paddlerec_tpu_torch.ops import gather_pool as gp

    return (collections.Counter(gp.gather_pool.launches_by_shape),
            collections.Counter(gp.gather_pool_bwd.launches_by_shape))


def _shard_keys(path: str) -> np.ndarray:
    """The keys of a cube shard, from its layout (u64 magic, dim, count,
    i64 keys[count], f32 values[count·dim])."""
    count = int(np.fromfile(path, np.uint64, 3)[2])
    return np.fromfile(path, np.int64, count, offset=24)


def _records(root: str) -> list:
    with open(os.path.join(root, "online_donefile.txt")) as f:
        return [(r["day"], r["pass"], r["kind"], os.path.relpath(r["path"], root))
                for r in map(json.loads, filter(str.strip, f))]


class OnlineWatch:
    """Wrappers around ``OnlineTrainer``'s methods for the runs inside a
    ``with`` block: each trainer, its initial parameters, the step losses
    (device scalars, read once after the run) and the streaming metrics of
    each pass (the join-time eval, then the train leg), the rows each shrink
    evicts, and ``on_delta(trainer, delta_dir, touched masks)`` after each
    publish.  ``init_from`` (a state_dict) replaces the initial parameters of
    each trainer (a CPU twin starts from the card's); ``on_init(state_dict)``
    is called with each trainer's initial parameters."""

    def __init__(self, on_delta=None, init_from=None, on_init=None):
        self.on_delta, self.init_from, self.on_init = on_delta, init_from, on_init
        self.trainers, self.init, self.passes = [], None, []
        self.losses, self.metrics, self.evicted = {}, {}, {}

    def __enter__(self):
        from paddlerec_tpu_torch.train.online import OnlineTrainer

        cls, watch = OnlineTrainer, self
        names = ("init_state", "train_step", "_compute_metrics", "train_pass", "save_delta",
                 "_zero_table_rows")
        # the class's own attributes, restored on exit (None: inherited)
        self._saved = {k: cls.__dict__.get(k) for k in names}
        orig = {k: getattr(cls, k) for k in names}

        def init_state(trainer, *a, **k):
            state = orig["init_state"](trainer, *a, **k)
            if watch.init_from is not None:
                state.module.load_state_dict(watch.init_from)
            watch.init = {n: v.detach().cpu().clone()
                          for n, v in state.module.state_dict().items()}
            watch.trainers.append(trainer)
            if watch.on_init is not None:
                watch.on_init(watch.init)
            return state

        def train_step(trainer, batch, metric_state):
            metric_state, loss = orig["train_step"](trainer, batch, metric_state)
            watch.losses.setdefault(watch.passes[-1], []).append(loss)
            return metric_state, loss

        def compute_metrics(trainer, metric_state):
            out = orig["_compute_metrics"](trainer, metric_state)
            watch.metrics.setdefault(watch.passes[-1], []).append(out)
            return out

        def train_pass(trainer, pass_dir, day, pass_id, dataset=None):
            watch.passes.append((day, pass_id))
            return orig["train_pass"](trainer, pass_dir, day, pass_id, dataset=dataset)

        def save_delta(trainer, root, tag):
            masks = {n: m.copy() for n, m in trainer._touched.items()}
            out = orig["save_delta"](trainer, root, tag)
            if watch.on_delta is not None:
                watch.on_delta(trainer, out, masks)
            return out

        def zero_rows(trainer, name, rows):
            watch.evicted[name] = np.array(rows)
            return orig["_zero_table_rows"](trainer, name, rows)

        for name, fn in (("init_state", init_state), ("train_step", train_step),
                         ("_compute_metrics", compute_metrics), ("train_pass", train_pass),
                         ("save_delta", save_delta), ("_zero_table_rows", zero_rows)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        from paddlerec_tpu_torch.train.online import OnlineTrainer

        for name, fn in self._saved.items():
            if fn is None:
                delattr(OnlineTrainer, name)
            else:
                setattr(OnlineTrainer, name, fn)

    def pass_losses(self) -> list:
        """The mean step loss of each trained pass."""
        return [float(torch.stack([l.float() for l in self.losses[p]]).mean().cpu())
                for p in self.passes]

    def join_aucs(self) -> list:
        """The join-time eval's AUC of each trained pass."""
        return [self.metrics[p][0]["auc"] for p in self.passes]


@_uncounted
def check_cube_delta(gp, trainer, out_dir: str, masks: dict, pass_rows=None) -> dict:
    """A published delta of packed tables against the card: each table's
    shards hold exactly the logical ids of its touched physical rows (and,
    given ``pass_rows``, those are the rows the pass's data maps to), and
    their vectors equal K1's gather of the same ids from the table's logical
    view as it stands, bitwise (float32 out, from a bfloat16 table as
    well).  Returns (keys by table, vectors by table, the check's numbers)."""
    from paddlerec_tpu_torch.native.cube import CubeClient
    from paddlerec_tpu_torch.ops.packed_embedding import sub_width

    with open(os.path.join(out_dir, "delta_meta.json")) as f:
        meta = json.load(f)
    vocab, dim = meta["vocab"], meta["dim"]
    w = sub_width(dim)
    pack = 128 // w
    keys_by, vals_by = {}, {}
    for name, table in trainer._embedding_entries():
        rows = np.nonzero(masks[name])[0]
        if pass_rows is not None and not np.array_equal(rows, pass_rows):
            raise AssertionError(f"{out_dir}: {name}'s touched rows are not the pass's rows")
        keys = (rows[:, None] * pack + np.arange(pack)[None, :]).reshape(-1)
        keys = keys[keys < vocab]
        shards = sorted(glob.glob(os.path.join(out_dir, name.replace("/", "_"),
                                               "cube_shard_*.bin")))
        stored = np.sort(np.concatenate([_shard_keys(s) for s in shards]))
        if len(shards) != 2 or not np.array_equal(stored, keys):
            raise AssertionError(f"{out_dir}: {len(shards)} shards holding {len(stored)} "
                                 f"keys, {len(keys)} touched")
        with CubeClient(shards) as client:
            got = client.seek(keys)
        ids = torch.from_numpy(keys.astype(np.int32)).cuda()[:, None]
        want = gp.gather_pool(table.detach().view(-1, w), ids, out_dtype=torch.float32,
                              mode="clip")[:, :dim].cpu().numpy()
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"{out_dir}: {name}'s vectors differ from K1's gather by "
                                 f"{float(np.abs(got - want).max())}")
        keys_by[name], vals_by[name] = keys, got
    return keys_by, vals_by, meta


def _unpacked(table: torch.Tensor, keys: np.ndarray, dim: int) -> np.ndarray:
    from paddlerec_tpu_torch.ops.packed_embedding import sub_width

    return table.float().numpy().reshape(-1, sub_width(dim))[keys, :dim]


def _serve(shard_paths: list) -> tuple:
    """One ``cube_server`` process a shard, each on a free port: (processes,
    addresses)."""
    import socket

    from paddlerec_tpu_torch.native.cube import start_cube_server

    procs, addrs = [], []
    try:
        for path in shard_paths:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            procs.append(start_cube_server(port, [path]))
            addrs.append(f"127.0.0.1:{port}")
    except Exception:
        _stop(procs)
        raise
    return procs, addrs


def _stop(procs) -> None:
    for proc in procs:
        proc.kill()
        proc.wait()


def _online_twin(argv: list, init_path: str, out_path: str, threads: int) -> None:
    """The CPU twin of phase 33, in a process of its own: ``tools/online_train``'s
    ``main`` with ``argv`` (``--device cpu``) from the parameters saved at
    ``init_path``; its per-pass losses, join-time AUCs and passes to
    ``out_path`` as JSON."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(threads)
    from paddlerec_tpu_torch.tools import online_train

    t0 = time.perf_counter()
    with OnlineWatch(init_from=torch.load(init_path, weights_only=True)) as run:
        online_train.main(argv)
    with open(out_path, "w") as f:
        json.dump({"pass_losses": run.pass_losses(), "join_aucs": run.join_aucs(),
                   "passes": run.passes, "seconds": time.perf_counter() - t0}, f)


class OnlineTwin:
    """Phase 33's CPU twin, run beside the card's phases 33-35: started once
    the card's trainer has its initial parameters, joined and compared by
    ``finish``; ``stop`` ends its process whatever happened."""

    def __init__(self, work: str, argv: list, out_root: str):
        self.work, self.argv, self.out_root = work, argv, out_root
        self.proc = None
        self.result = os.path.join(work, "online_twin.json")

    def start(self, init: dict) -> None:
        import multiprocessing

        if self.proc is not None:
            return
        path = os.path.join(self.work, "online_twin_init.pt")
        torch.save(init, path)
        # all but two of the host's cores: the card's phases beside it run
        # one Python thread and single-threaded numpy and cube builds
        threads = max(1, (os.cpu_count() or 4) - 2)
        self.started = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_online_twin, args=(self.argv, path, self.result, threads), daemon=True)
        self.proc.start()

    def stop(self) -> None:
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
        if self.proc is not None:
            self.proc.join()

    def finish(self, card_row: dict, timeout: float = 600.0) -> dict:
        """Wait for the twin; its per-pass losses (atol 1e-4: float32 sums in
        another order over 256 Adam steps) and join-time AUCs (atol 1e-3)
        against the card's, its records and every ``delta_meta.json`` equal
        to the card's."""
        t0 = time.perf_counter()
        self.proc.join(timeout)
        waited = time.perf_counter() - t0
        if self.proc.is_alive() or self.proc.exitcode != 0:
            self.stop()
            raise AssertionError(f"the CPU twin ended with {self.proc.exitcode}")
        with open(self.result) as f:
            twin = json.load(f)
        loss_err = float(np.abs(np.subtract(card_row["pass_losses"],
                                            twin["pass_losses"])).max())
        auc_err = float(np.abs(np.subtract(card_row["join_aucs"], twin["join_aucs"])).max())
        card_root = card_row.pop("root")
        metas = []
        for p in range(len(card_row["join_aucs"])):
            tag = f"delta_{ONLINE_DAY}_{p}"
            with open(os.path.join(card_root, tag, "delta_meta.json")) as f, \
                    open(os.path.join(self.out_root, tag, "delta_meta.json")) as g:
                metas.append(json.load(f) == json.load(g))
        records = _records(self.out_root) == card_row["records_full"]
        if (loss_err > 1e-4 or auc_err > 1e-3 or not records or not all(metas)
                or [tuple(p) for p in twin["passes"]] != card_row["pass_keys"]):
            raise AssertionError(f"slot_dnn online, card against CPU: losses {loss_err}, "
                                 f"AUCs {auc_err}, records {records}, delta_meta {metas}")
        return {"max_pass_loss_err": loss_err, "max_join_auc_err": auc_err,
                "records_equal": records, "delta_meta_equal": all(metas),
                "pass_losses": twin["pass_losses"], "seconds": twin["seconds"],
                "waited_s": waited, "wall_s": time.perf_counter() - self.started}


def online_slot_dnn(gp, work: str, seed: int, card: str, twin_box: list) -> dict:
    """Phase 33: ``configs/rank/slot_dnn/config.yaml`` at its full width
    (vocab 1,000,001, dim 9, 27 slots, tower [512, 256, 128, 32], Adam,
    batch 32) through ``tools/online_train.py``'s ``main`` on the card, one
    day of four passes of ``ONLINE_ROWS`` planted-signal rows, each pass
    directory marked by a data donefile; the first base, a checkpoint every
    2 passes, a delta every pass in 2 cube shards, the day's shrink at
    ``ONLINE_EVICT`` and its base:
      * each delta against K1's gather from the card's table at its publish
        (``check_cube_delta``), and against a checkpoint of the same state:
        the loop's own where it wrote one at that pass, else one the check
        writes (bitwise, the numpy unpack of the checkpoint's table);
      * the CPU port on the same day from the card's initial parameters, in
        a process of its own beside the card's phases 33-35 (``OnlineTwin``,
        put into ``twin_box``; its ``finish`` compares);
      * the evicted rows exactly 0 in the table and both Adam moments, every
        other value as the last checkpoint (before the shrink) holds it;
      * a second run of the day trains no pass and writes no record;
      * the day's base through ``tools/export_cube.py`` into 2 shards,
        served by two ``cube_server`` processes: ``RemoteCubeClient.seek``
        of every key and ``NEVER_SEEN`` keys past the table equal to K1's
        gather from the final table (drop mode: zeros past it), bitwise."""
    from paddlerec_tpu_torch.core.config import Config
    from paddlerec_tpu_torch.native.cube import RemoteCubeClient
    from paddlerec_tpu_torch.tools import export_cube, online_train
    from paddlerec_tpu_torch.train import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    data, out, cpu_out = (os.path.join(work, d) for d in ("online", "online_out", "online_cpu"))
    snaps = os.path.join(work, "online_snapshots")
    cfg = online_config(SLOT_DNN, data, out, **{
        "runner.split_interval": ONLINE_SPLIT, "runner.checkpoint_per_pass": 2,
        "runner.save_first_base": True, "runner.seed": seed})
    vocab = int(cfg.hyper("sparse_feature_number"))
    write_online_day(data, ONLINE_SPLIT,
                     lambda d, s: write_train_data(d, ONLINE_ROWS, vocab, s), seed + 33)
    args = ["-m", SLOT_DNN, "-o", *_overrides(cfg)]
    checked = []

    @_uncounted
    def on_delta(trainer, out_dir, masks):
        keys, vals, meta = check_cube_delta(gp, trainer, out_dir, masks)
        (name,) = keys
        tag = os.path.basename(out_dir).replace("delta_", "ckpt_")
        if os.path.exists(os.path.join(out, tag)):
            table = ckpt_lib.load_model(out, tag)[0]["embedding.embedding"]
        else:
            ckpt_lib.save_params_only(trainer.state.module.state_dict(), snaps, tag)
            table = ckpt_lib.load_params_only(snaps, tag)["embedding.embedding"]
        if _unpacked(table, keys[name], meta["dim"]).tobytes() != vals[name].tobytes():
            raise AssertionError(f"{out_dir}: the delta differs from the checkpoint {tag}")
        checked.append({"delta": os.path.basename(out_dir), "keys": int(len(keys[name])),
                        "rows_touched": meta["rows_touched"],
                        "bytes": sum(os.path.getsize(p) for p in glob.glob(
                            os.path.join(out_dir, "*", "*")))})

    cpu_cfg = Config({**cfg.to_dict(), "runner.model_save_path": cpu_out})
    twin = OnlineTwin(work, ["-m", SLOT_DNN, "-o", *_overrides(cpu_cfg), "--device", "cpu"],
                      cpu_out)
    twin_box.append(twin)
    before = _counted()
    with OnlineWatch(on_delta, on_init=twin.start) as card_run:
        metrics = online_train.main(args)
    trainer = card_run.trainers[0]
    k1, k1b = (sum(c.values()) for c in _launches(before))
    card_s = time.perf_counter() - t0
    steps = ONLINE_ROWS // int(cfg.runner("train_batch_size"))
    # one K1 a step of each leg and one a delta; one K1b a train step
    if (trainer.device.type != "cuda" or len(checked) != 4 or len(card_run.passes) != 4
            or (k1, k1b) != (4 * 2 * steps + 4, 4 * steps)):
        raise AssertionError(f"slot_dnn online: {trainer.device}, {len(checked)} deltas, "
                             f"passes {card_run.passes}, K1 {k1}, K1b {k1b}")
    table = trainer.state.module.embedding.embedding.detach()
    opt = trainer.state.opt_state
    # the evicted rows are 0 in the table and its moments; all else is as the
    # last checkpoint, written before the shrink, holds it
    (name, evicted), = card_run.evicted.items()
    params, opt_last, _ = ckpt_lib.load_model(out, f"ckpt_{ONLINE_DAY}_3")
    keep = np.ones(table.shape[0], bool)
    keep[evicted] = False
    keep_t = torch.from_numpy(keep).cuda()
    for now, last in ((table, params["embedding.embedding"]),
                      (opt["mu"]["embedding.embedding"], opt_last["mu"]["embedding.embedding"]),
                      (opt["nu"]["embedding.embedding"], opt_last["nu"]["embedding.embedding"])):
        if now[~keep_t].any() or not torch.equal(now[keep_t].cpu(), last[keep]):
            raise AssertionError("the shrink left an evicted row or changed a kept one")
    if not 0 < len(evicted) < int(trainer.stats[name].seen.sum()) + len(evicted):
        raise AssertionError(f"{len(evicted)} rows evicted")
    records = _records(out)

    # a second run of the day: every pass is done
    with OnlineWatch() as again:
        online_train.main(args)
    if again.passes or _records(out) != records:
        raise AssertionError(f"the second run trained {again.passes}")
    again.trainers.clear()

    # the day's base to two cube shards, served by two daemons
    t2 = time.perf_counter()
    cube_dir = os.path.join(work, "online_cube")
    base = os.path.join(out, f"base_{ONLINE_DAY}")
    if export_cube.main(["-m", SLOT_DNN, "--out", cube_dir, "--shards", "2", "-o",
                         *_overrides(Config({**cfg.to_dict(),
                                             "runner.model_init_path": base}))]) != 0:
        raise AssertionError("export_cube found no table")
    export_s = time.perf_counter() - t2
    shards = sorted(glob.glob(os.path.join(cube_dir, "embedding_embedding", "*.bin")))
    view = table.view(-1, 16)
    keys = np.concatenate([np.arange(vocab), view.shape[0] + np.arange(NEVER_SEEN)])
    procs, addrs = _serve(shards)
    try:
        t3 = time.perf_counter()
        with RemoteCubeClient(addrs) as remote:
            served = remote.seek(keys)
        seek_s = time.perf_counter() - t3
    finally:
        _stop(procs)
    want = _uncounted(gp.gather_pool)(view, torch.from_numpy(keys.astype(np.int32)).cuda()[:, None],
                                      mode="drop").cpu().numpy()
    if len(shards) != 2 or served.tobytes() != want.tobytes() or served[-NEVER_SEEN:].any():
        raise AssertionError("the served base differs from K1's gather of the final table")
    out_row = {
        "model": "rank.slot_dnn", "vocab": vocab, "passes": len(card_run.passes),
        "rows_a_pass": ONLINE_ROWS, "records": [r[2] for r in records],
        "pass_losses": card_run.pass_losses(), "join_aucs": card_run.join_aucs(),
        "auc": metrics["auc"], "deltas": checked, "evicted_rows": int(len(evicted)),
        "seen_rows_after_shrink": int(trainer.stats[name].seen.sum()),
        "root": out, "records_full": records, "pass_keys": card_run.passes,
        "base_served": {"keys": int(len(keys)), "servers": len(addrs),
                        "export_s": export_s, "seek_s": seek_s, "bitwise": True},
        "phase_times": {k: v for k, v in metrics.items() if k.startswith("phase_")},
        "card_run_s": card_s, "k1": k1, "k1b": k1b,
    }
    card_run.trainers.clear()
    del trainer, table, view, opt
    return out_row


def online_bigdata(gp, work: str, seed: int, card: str) -> dict:
    """Phase 34: ``configs/rank/deepfm/config_bigdata.yaml`` online at its
    full vocabulary (100,000,001 ids, the 3.2 GB bfloat16 table, row-wise
    adagrad with stochastic rounding, batch 8192; the Python reader of
    slotbin files, ``feed_superbatch`` 3 and ``wire_format: compact``), one
    day of four passes of ``BIG_ONLINE_BATCHES`` batches over the whole
    vocabulary (half of the ids from 4,096 hot ids per slot), a delta every
    pass, no checkpoint inside the day, the day's shrink and base:
      * each delta holds exactly the logical ids of the physical rows its
        pass's data maps to, and their vectors equal K1's bfloat16 → float32
        gather from the card's table at its publish, bitwise
        (``check_cube_delta``);
      * two ``cube_server`` processes answer the last delta as its shards do;
      * the evicted rows are 0 in the table and its row state.
    Prints the rows touched, each delta's bytes against the table's, the
    ``FeatureStats`` over its 12.5 M physical rows and the loop's
    ``phase_times``."""
    from paddlerec_tpu_torch.data.binary import SlotBinFile
    from paddlerec_tpu_torch.native.cube import RemoteCubeClient
    from paddlerec_tpu_torch.train.online import OnlineTrainer

    t0 = time.perf_counter()
    data, out = os.path.join(work, "online_big"), os.path.join(work, "online_big_out")
    cfg = online_config(BIGDATA.format("deepfm"), data, out, **{
        "runner.split_interval": ONLINE_SPLIT, "runner.checkpoint_per_pass": 1000,
        "runner.reader_type": "", "runner.feed_superbatch": BIG_ONLINE_BATCHES,
        "runner.wire_format": "compact", "runner.seed": seed})
    vocab, batch = int(cfg.hyper("sparse_feature_number")), int(cfg.runner("train_batch_size"))
    dirs = write_online_day(data, ONLINE_SPLIT, lambda d, s: write_sparse_train_data(
        d, BIG_ONLINE_BATCHES * batch, vocab, s, files=1), seed + 34)
    pass_rows = []
    for d in dirs:
        ids = np.concatenate([np.asarray(SlotBinFile(f).sparse).reshape(-1)
                              for f in sorted(glob.glob(os.path.join(d, "*.bin")))])
        pass_rows.append(np.unique((ids.astype(np.int64) % vocab) // 8))
    data_s = time.perf_counter() - t0
    deltas, last = [], {}

    def on_delta(trainer, out_dir, masks):
        t = time.perf_counter()
        p = int(out_dir.rsplit("_", 1)[1])
        keys, vals, meta = check_cube_delta(gp, trainer, out_dir, masks, pass_rows[p])
        last.update(dir=out_dir, keys=keys["embedding/embedding"],
                    vals=vals["embedding/embedding"])
        deltas.append({"delta": os.path.basename(out_dir), "rows_touched": meta["rows_touched"],
                       "keys": int(len(last["keys"])),
                       "bytes": sum(os.path.getsize(f) for f in glob.glob(
                           os.path.join(out_dir, "*", "*"))),
                       "check_s": time.perf_counter() - t})

    before = _counted()
    t1 = time.perf_counter()
    with OnlineWatch(on_delta) as run:
        trainer = OnlineTrainer(cfg)
        trainer.init_state(seed=seed)
        init_s = time.perf_counter() - t1
        metrics = trainer.run()
    run_s = time.perf_counter() - t1
    k1, k1b = (sum(c.values()) for c in _launches(before))
    table = trainer.state.module.embedding.embedding.detach()
    acc = trainer.state.extra["embedding/embedding_delta"].acc
    table_bytes = table.numel() * table.element_size()
    if (tuple(table.shape) != (12500001, 128) or table.dtype != torch.bfloat16
            or len(deltas) != 4 or (k1, k1b) != (4 * 2 * BIG_ONLINE_BATCHES + 4,
                                                 4 * BIG_ONLINE_BATCHES)):
        raise AssertionError(f"the 10^8 online run: {tuple(table.shape)} {table.dtype}, "
                             f"{len(deltas)} deltas, K1 {k1}, K1b {k1b}")
    name = "embedding/embedding"
    evicted = run.evicted.get(name, np.zeros(0, np.int64))
    rows = torch.from_numpy(evicted).cuda()
    if len(evicted) and (table[rows].any() or acc[rows].any()):
        raise AssertionError("an evicted row of the 10^8 table is not 0")
    stats = trainer.stats[name]
    shards = sorted(glob.glob(os.path.join(last["dir"], "embedding_embedding", "*.bin")))
    procs, addrs = _serve(shards)
    try:
        t2 = time.perf_counter()
        with RemoteCubeClient(addrs) as remote:
            served = remote.seek(last["keys"])
        seek_s = time.perf_counter() - t2
    finally:
        _stop(procs)
    if served.tobytes() != last["vals"].tobytes():
        raise AssertionError("the servers answer the last delta otherwise than its shards")
    out_row = {
        "config": "configs/rank/deepfm/config_bigdata.yaml", "vocab": vocab,
        "table_shape": list(table.shape), "table_bytes": table_bytes, "batch": batch,
        "passes": len(run.passes), "batches_a_pass": BIG_ONLINE_BATCHES,
        "deltas": [dict(d, bytes_over_table=d["bytes"] / table_bytes) for d in deltas],
        "feature_stats": {"physical_rows": int(len(stats.show)),
                          "seen_after_shrink": int(stats.seen.sum()),
                          "evicted": int(len(evicted))},
        "last_delta_served": {"keys": int(len(last["keys"])), "servers": len(addrs),
                              "seek_s": seek_s, "bitwise": True},
        "pass_losses": run.pass_losses(), "join_aucs": run.join_aucs(),
        "phase_times": {k: v for k, v in metrics.items() if k.startswith("phase_")},
        "data_s": data_s, "init_s": init_s, "run_s": run_s, "k1": k1, "k1b": k1b,
    }
    run.trainers.clear()
    del trainer, table, acc, rows
    gc.collect()
    torch.cuda.empty_cache()
    return out_row


@_uncounted
def check_npz_delta(gp, trainer, out_dir: str, masks: dict, pass_rows: dict) -> dict:
    """A delta of unpacked tables (din's) against the card: each table's
    ``<name>_delta.npz`` holds exactly the rows the pass's batches name
    through the model's ``touched_tables``, and their values equal K1's
    gather of those rows from the table at its publish, bitwise."""
    touched = {}
    for name, table in trainer._embedding_entries():
        npz = np.load(os.path.join(out_dir, f"{name.replace('/', '_')}_delta.npz"))
        rows = np.nonzero(masks[name])[0]
        if not (np.array_equal(npz["rows"], rows) and np.array_equal(rows, pass_rows[name])):
            raise AssertionError(f"{out_dir}: {name}'s rows are not the pass's")
        ids = torch.from_numpy(rows.astype(np.int32)).cuda()[:, None]
        want = gp.gather_pool(table.detach(), ids, mode="clip").cpu().numpy()
        if npz["values"].tobytes() != want.tobytes():
            raise AssertionError(f"{out_dir}: {name}'s values differ from K1's gather")
        touched[name] = int(len(rows))
    return touched


def online_din(gp, work: str, seed: int, card: str) -> dict:
    """Phase 35: ``configs/rank/din/config.yaml`` at its defaults (item
    table 63,001 × 64, category table 801 × 64, item bias, batch 32) online,
    one day of two passes of ``DIN_ONLINE_ROWS`` planted-signal rows, a
    delta every pass, a checkpoint at the day's last pass, the shrink at
    ``ONLINE_EVICT`` and the base: every delta covers the three tables that
    ``touched_tables`` names (``check_npz_delta``), and the shrink acts on
    each table by its own counters: its evicted rows 0 in the table and both
    Adam moments, every other value as the checkpoint before the shrink."""
    from paddlerec_tpu_torch.train import checkpoint as ckpt_lib
    from paddlerec_tpu_torch.train.online import OnlineTrainer

    t0 = time.perf_counter()
    data, out = os.path.join(work, "online_din"), os.path.join(work, "online_din_out")
    cfg = online_config(DIN, data, out, **{
        "runner.split_interval": 720, "runner.checkpoint_per_pass": 2, "runner.seed": seed})
    dirs = write_online_day(data, 720, lambda d, s: write_din_data(d, DIN_ONLINE_ROWS, s),
                            seed + 35)
    deltas = []
    before = _counted()
    with OnlineWatch() as run:
        trainer = OnlineTrainer(cfg)
        md = trainer.model_def
        pass_rows = []
        for d in dirs:
            hooked = collections.defaultdict(list)
            for b in md.make_dataset(d, int(cfg.runner("train_batch_size"))):
                for name, r in md.touched_tables(b).items():
                    hooked[name].append(r)
            pass_rows.append({n: np.unique(np.concatenate(r)) for n, r in hooked.items()})
        run.on_delta = lambda tr, out_dir, masks: deltas.append(check_npz_delta(
            gp, tr, out_dir, masks, pass_rows[int(out_dir.rsplit("_", 1)[1])]))
        trainer.run()
    k1, k1b = (sum(c.values()) for c in _launches(before))
    steps = DIN_ONLINE_ROWS // SEQ_BATCH
    tables = {"item_emb/embedding", "cat_emb/embedding", "item_b/embedding"}
    if (len(deltas) != 2 or any(set(d) != tables for d in deltas)
            or (k1, k1b) != (2 * 3 * 2 * steps + 2 * 3, 2 * 3 * steps)):
        raise AssertionError(f"din online: deltas {deltas}, K1 {k1}, K1b {k1b}")
    params, opt_last, _ = ckpt_lib.load_model(out, f"ckpt_{ONLINE_DAY}_1")
    state = dict(trainer.state.module.named_parameters())
    opt = trainer.state.opt_state
    evicted = {}
    for name in tables:
        key = name.replace("/", ".")
        rows = run.evicted.get(name, np.zeros(0, np.int64))
        keep = np.ones(state[key].shape[0], bool)
        keep[rows] = False
        keep_t = torch.from_numpy(keep).cuda()
        for now, last in ((state[key].detach(), params[key]),
                          (opt["mu"][key], opt_last["mu"][key]),
                          (opt["nu"][key], opt_last["nu"][key])):
            if now[~keep_t].any() or not torch.equal(now[keep_t].cpu(), last[keep]):
                raise AssertionError(f"din's shrink of {name} left an evicted row or "
                                     "changed a kept one")
        evicted[name] = int(len(rows))
    # item_b and item_emb see the same rows; the category table has its own
    if (not evicted["item_emb/embedding"]
            or not np.array_equal(run.evicted["item_emb/embedding"],
                                  run.evicted["item_b/embedding"])):
        raise AssertionError(f"din's shrink: {evicted}")
    run.trainers.clear()
    del trainer, state, opt
    return {"model": "rank.din", "passes": len(run.passes), "rows_a_pass": DIN_ONLINE_ROWS,
            "touched_rows_by_delta": deltas, "evicted_by_table": evicted,
            "pass_losses": run.pass_losses(), "join_aucs": run.join_aucs(),
            "seconds": time.perf_counter() - t0, "k1": k1, "k1b": k1b}


def online_k1_shapes(k1_by: collections.Counter) -> tuple:
    """Phase 36's K1 rows: each lookup of phases 33-35 at its batch, and each
    table's delta gather (its touched packed or plain rows, sorted and
    distinct, N the largest of the run's deltas).  Returns (shapes, the
    (rows, D, dtype, N, pool) of the lookups)."""
    lookups = (
        K1Shape("slot_dnn view, B=32", 125001 * 8, 16, SEQ_BATCH * SLOTS, vocab=1000001,
                library="embedding"),
        K1Shape("config_bigdata.yaml bf16 view into float32, B=8192", 12500001 * 8, 16,
                8192 * SLOTS, vocab=100000001, dtype="bfloat16"),
        K1Shape("din item_emb, B=32", 63001, 64, SEQ_BATCH * 129, mode="fill",
                library="embedding"),
        K1Shape("din cat_emb, B=32", 801, 64, SEQ_BATCH * 129, mode="fill",
                library="embedding"),
        K1Shape("din item_b, B=32", 63001, 1, SEQ_BATCH, mode="fill", library="embedding"),
    )
    named = {(s.rows, s.dim, s.dtype, s.n, s.pool) for s in lookups}
    gathers = []
    for what, rows, dim, dtype in (("slot_dnn", 125001, 128, "float32"),
                                   ("config_bigdata.yaml", 12500001, 128, "bfloat16"),
                                   ("din item_emb", 63001, 64, "float32"),
                                   ("din cat_emb", 801, 64, "float32"),
                                   ("din item_b", 63001, 1, "float32")):
        ns = [k[3] for k in k1_by if k[:3] == (rows, dim, dtype) and k[4] == 1
              and k not in named]
        if not ns:
            raise AssertionError(f"no delta of {what} launched K1: {dict(k1_by)}")
        gathers.append(K1Shape(f"{what} delta: touched rows, N the run's largest", rows,
                               dim, max(ns), ids="sorted unique", dtype=dtype,
                               library=None if dtype == "bfloat16" else "embedding"))
    return lookups + tuple(gathers), named


def online_k1b_shapes() -> tuple:
    """Phase 36's K1b rows: slot_dnn's view at its batch and din's category
    table are new; din's item tables (phase 15) and the 10^8 run's compact
    rows (phase 10) have their cases, which count the launches of their
    key."""
    return (
        K1bShape("slot_dnn view, B=32", 125001 * 8, 16, SEQ_BATCH * SLOTS, vocab=1000001),
        K1bShape("din cat_emb, B=32", 801, 64, SEQ_BATCH * 129, mode="fill"),
    )


def _earlier_k1b(key) -> bool:
    rows, dim, dtype, n = key
    seq = {(r, d, "float32", n) for _, r, d, n, _ in SEQ_SHAPES}
    return key in seq or (dim, dtype, n) == (16, "float32", 8192 * SLOTS)


def online_phases(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 33-36: the online loop on slot_dnn, the 10^8 table and din,
    then phase 36, K1 at every shape of theirs and K1b at their new shapes,
    each checked against its plain version and timed.  Every K1 launch of
    phases 33-35 is at a case (a delta gather's at its table's, whatever its
    N); every K1b launch at a case or at an earlier phase's.  Returns (K1
    cases, K1b cases, K1 launches, K1b launches)."""
    before = _counted()

    def lap(phase: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap(phase)

    twin = []
    try:
        slot_dnn = online_slot_dnn(gp, work, seed, card, twin)
        lap("33 online slot_dnn")
        emit({"online_bigdata": online_bigdata(gp, work, seed, card), "card": card})
        lap("34 online 10^8")
        emit({"online_din": online_din(gp, work, seed, card), "card": card})
        lap("35 online din")
        slot_dnn["cpu_twin"] = twin[0].finish(slot_dnn)
        for key in ("records_full", "pass_keys"):
            slot_dnn.pop(key)
        emit({"online_slot_dnn": slot_dnn, "card": card})
        clock.lap("33 the CPU twin's rest (beside 33-35)")
    finally:
        for t in twin:
            t.stop()
    k1_by, k1b_by = _launches(before)
    shapes, lookups = online_k1_shapes(k1_by)
    k1_cases = time_k1_shapes(gp, shapes, seed + 36)
    k1b_cases = time_k1b_shapes(gp, online_k1b_shapes(), seed + 36)
    k1, k1b = attribute_online_launches(k1_cases, k1b_cases, k1_by, k1b_by, lookups)
    clock.lap("36 K1/K1b at the online shapes")
    return k1_cases, k1b_cases, k1, k1b


def attribute_online_launches(k1_cases, k1b_cases, k1_by, k1b_by, lookups) -> tuple:
    """Set each phase-36 case's ``launches`` from the launches by shape of
    phases 33-35, and check that every K1 launch is at a case and every K1b
    launch at a case or an earlier phase's.  Returns the K1 and K1b
    totals."""
    for case in k1_cases:
        group = (case["rows"], case["dim"], case["dtype"], case["pool"])
        # a delta gather's N follows the data: its case takes every key of its
        # table that no lookup names (one id a row: the gathers and lookups
        # of a table share rows, D, dtype and pool)
        case["launches"] = (sum(v for k, v in k1_by.items()
                                if (*k[:3], k[4]) == group and k not in lookups)
                            if case["ids"] == "sorted unique" else
                            k1_by.get((*group[:3], case["n"], case["pool"]), 0))
    keys = {(c["rows"], c["dim"], c["dtype"], c["n"]) for c in k1b_cases}
    for case in k1b_cases:
        case["launches"] = k1b_by.get((case["rows"], case["dim"], case["dtype"], case["n"]), 0)
    k1, k1b = sum(k1_by.values()), sum(k1b_by.values())
    if (sum(c["launches"] for c in k1_cases) != k1
            or not all(c["launches"] > 0 for c in k1_cases)):
        raise AssertionError(f"phases 33-35 launched K1 {k1} times, by shape {dict(k1_by)}")
    if (any(k not in keys and not _earlier_k1b(k) for k in k1b_by)
            or not all(c["launches"] > 0 for c in k1b_cases)):
        raise AssertionError(f"phases 33-35 launched K1b {k1b} times, by shape {dict(k1b_by)}")
    return k1, k1b


def online_only(gp, seed: int, card: str) -> None:
    """``--only 33-36``: phases 33-36, one JSON line a K1 and a K1b shape,
    and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, k1, k1b = online_phases(gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"online_only": {"k1_launches": k1, "k1b_launches": k1b,
                          "launch_floor_ms": floor_ms}, "card": card})
    emit(clock.line(card))


def slice_only(gp, seed: int, card: str) -> None:
    """``--only 29-32``: phases 29-32, one JSON line a K1 and a K1b shape,
    and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, k1, k1b = tree_rl_demo(gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"slice_only": {"k1_launches": k1, "k1b_launches": k1b,
                         "launch_floor_ms": floor_ms}, "card": card})
    emit(clock.line(card))


# -- phases 37-41: the host-tiered table, the resident and native feeds, ------
# -- observability and K1/K1b at their shapes ---------------------------------
HOST_CACHE_ROWS = 1 << 20  # host_table_cache_rows: a 256 MB bf16 cache
HOST_RAM_ROWS = 500_000  # the spill leg's RAM slab: below the rows the run touches
HOST_PASSES = 3  # files, one a pass
HOST_BATCHES = 8  # batches of 8192 a pass
# a pass touches ~415,000 physical rows (~347,000 of the hot ids, ~68,000
# uniform), the run ~555,000: the spill leg evicts ~55,000 rows to disk
HOST_HOT = 350_000  # ids every pass draws from
HOST_UNIFORM = 0.04  # the share of ids drawn uniformly over the whole vocabulary
HOST_FIRST_STEPS = 2  # steps of the first pass held against the port's CPU run
RESIDENT_EPOCHS = 3
OBS_BATCHES = 4  # phase 40's whole batches of 8192; evaluation adds a padded tail
BIG_BATCH = 8192


def write_host_table_data(data_dir: str, vocab: int, seed: int) -> list:
    """``HOST_PASSES`` slotbin files of ``HOST_BATCHES`` batches of 8192
    Criteo-shaped rows, a file a pass: each id from ``HOST_HOT`` ids spread
    over the whole vocabulary (the same for every pass) or, with probability
    ``HOST_UNIFORM``, uniform over [1, vocab); the label carries the
    per-id signal of ``write_sparse_train_data`` and a stronger one in the
    first dense feature, which the tower learns within the run's 24 steps."""
    from paddlerec_tpu_torch.data.binary import write_slotbin

    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    hot = rng.randint(1, vocab, HOST_HOT).astype(np.int64)
    n = HOST_BATCHES * BIG_BATCH
    paths = []
    for p in range(HOST_PASSES):
        sparse = hot[rng.randint(0, HOST_HOT, (n, SLOTS))]
        uniform = rng.rand(n, SLOTS) < HOST_UNIFORM
        sparse[uniform] = rng.randint(1, vocab, int(uniform.sum()))
        dense = rng.rand(n, 13).astype(np.float32)
        w = ((sparse * 2654435761) % 1000) / 1000.0 - 0.5
        score = w.mean(axis=1) * 8.0 + (dense[:, 0] - 0.5) * 6.0
        label = (rng.rand(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.float32)
        paths.append(os.path.join(data_dir, f"pass-{p}.bin"))
        write_slotbin(paths[-1], label, sparse.astype(np.int32), dense)
    return paths


def host_config(data: str, seed: int, **extra):
    """``configs/rank/dnn/config_bigdata.yaml`` through the host-tiered pass
    loop: a 1,048,576-row cache, a file a pass, superbatches of 4 over the
    compact wire, slotbin files."""
    from paddlerec_tpu_torch.core.config import Config, load_config

    flat = dict(load_config(BIGDATA.format("dnn")).to_dict())
    flat.update({
        "runner.train_data_dir": data, "runner.model_save_path": None,
        "runner.reader_type": "", "runner.use_host_table": True,
        "runner.host_table_cache_rows": HOST_CACHE_ROWS, "runner.files_per_pass": 1,
        "runner.feed_superbatch": 4, "runner.wire_format": "compact",
        "runner.print_interval": 1000, "runner.seed": seed,
    })
    flat.update(extra)
    return Config(flat)


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _seeded_rounding(cast, seed: int):
    """A stand-in for ``ops.sparse_update._cast_to_table`` (``cast``) that
    rounds a bf16 table's rows stochastically with noise from
    ``RandomState(seed + call)`` on the host, so that the card and the CPU
    draw the same noise."""
    from paddlerec_tpu_torch.ops import sparse_update as su

    calls = itertools.count()

    def cast_to_table(t_n, table, rng):
        if table.dtype != torch.bfloat16 or rng is None:
            return cast(t_n, table, rng)
        noise = np.random.RandomState(seed + next(calls)).randint(
            0, 1 << 16, tuple(t_n.shape)).astype(np.int32)
        return su.stochastic_round_bf16(t_n, torch.from_numpy(noise).to(t_n.device))
    return cast_to_table


def host_first_steps(cfg, pass_file: str, seed: int) -> dict:
    """The first ``HOST_FIRST_STEPS`` steps of the first pass on the card
    against the port's CPU run of the same pass: one host tier (so its fresh
    rows are drawn once), the same initial parameters, the same host-deduped
    batches and the same stochastic-rounding noise (loss atol 1e-4)."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.ops import sparse_update as su
    from paddlerec_tpu_torch.train.host_loop import HostTableTrainer
    from paddlerec_tpu_torch.train.trainer import _count_uniq

    card = HostTableTrainer(cfg)
    card.trainer.init_state(seed=seed)
    host = HostTableTrainer(cfg, device="cpu")
    host.trainer.init_state(seed=seed)
    host.trainer.state.module.load_state_dict(
        {k: v.cpu() for k, v in card.trainer.state.module.state_dict().items()})
    host.table = card.table
    batches = list(card._pass_dataset([pass_file], BIG_BATCH))
    phys = np.unique(np.concatenate([(np.asarray(b["sparse"]).reshape(-1).astype(np.int64)
                                      % card.vocab) // card.pack for b in batches]))
    losses, cast = {}, su._cast_to_table
    try:
        for name, ht in (("cuda", card), ("cpu", host)):
            su._cast_to_table = _seeded_rounding(cast, seed)
            ht._tap = ht._find_tap()
            ht._swap_in_pass(phys)
            ms, losses[name] = ht.trainer._init_metric_state(), []
            for b in batches[:HOST_FIRST_STEPS]:
                b = _count_uniq(ht.trainer.model_def.augment_batch_host(ht._translate_batch(b)))
                ms, loss = ht.trainer.train_step(to_tensors(b, ht.device), ms)
                losses[name].append(float(loss))
    finally:
        su._cast_to_table = cast
    u = len(phys)
    rows = [ht._tap[1].embedding.detach()[:u].float().cpu() for ht in (card, host)]
    err = float(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"])).max())
    if not np.all(np.isfinite(losses["cuda"])) or err > 1e-4:
        raise AssertionError(f"the cache's first steps: card and CPU losses differ by {err}: "
                             f"{losses}")
    return {"steps": HOST_FIRST_STEPS, "rows_cached": u, "loss_cuda": losses["cuda"],
            "loss_cpu": losses["cpu"], "max_abs_err_loss_vs_cpu": err,
            "max_abs_err_cache_vs_cpu": float((rows[0] - rows[1]).abs().max()),
            "cache_elements_differing": int((rows[0] != rows[1]).sum())}


def _record_tier(table) -> list:
    """Wrap ``table``'s ``begin_pass`` and ``end_pass`` so that each pass
    appends ``[ids asked for, rows read, rows flushed]`` to the list
    returned.  It keeps references: the pass loop writes neither array after
    the call."""
    log = []
    begin, end = table.begin_pass, table.end_pass

    def begin_pass(ids):
        rows = begin(ids)
        log.append([ids, rows, None])
        return rows

    def end_pass(cache):
        end(cache)
        log[-1][2] = cache

    table.begin_pass, table.end_pass = begin_pass, end_pass
    return log


def replay_tier(table, log: list) -> dict:
    """Replay the passes ``_record_tier`` kept of ``table`` (the spill leg's
    tiered table) into a RAM-only ``HostTieredTable`` of the same seed: each
    pass's rows read and the final ``snapshot_rows`` must be the RAM tier's
    bitwise.  This holds the mmap tier (its prefetch, its eviction to disk and
    its reads back) to the RAM tier exactly, whatever order the card's float
    atomics took in the training that produced the flushed rows."""
    from paddlerec_tpu_torch.parallel.host_table import HostTieredTable

    twin = HostTieredTable(table.vocab, table.dim, seed=table.seed,
                           init_scale=table.init_scale, show_decay=table.show_decay)
    differing = []
    for ids, rows, flushed in log:
        got = twin.begin_pass(ids)
        differing.append(int((got != rows).sum()) if got.shape == rows.shape else None)
        twin.end_pass(flushed)
    ids_t, vals_t = twin.snapshot_rows()
    ids_s, vals_s = table.snapshot_rows()
    same_ids = bool(np.array_equal(ids_t, ids_s))
    out = {"passes": len(log), "rows_read_differing": differing, "ids_equal": same_ids,
           "rows": int(len(ids_s)),
           "elements_differing": int((vals_t != vals_s).sum()) if same_ids else None}
    if not (same_ids and out["elements_differing"] == 0 and differing
            and all(d == 0 for d in differing)):
        raise AssertionError(f"the spill tier disagrees with a RAM tier fed the same passes: {out}")
    return out


def host_leg(cfg, seed: int, record_tier: bool = False) -> tuple:
    """One epoch of ``HostTableTrainer.train()`` on the card: one K1 and one
    K1b launch a step, the loss finite and falling over the epoch, and the
    peak allocation held under cache + row state + dense parameters and
    moments + 1 GB.  With ``record_tier`` the table's passes are kept
    (``_record_tier``) in the trainer's ``tier_log``.  Returns (trainer,
    result)."""
    from paddlerec_tpu_torch.train.host_loop import HostTableTrainer

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ht = HostTableTrainer(cfg)
    ht.tier_log = _record_tier(ht.table) if record_tier else None
    ht.trainer.init_state(seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, step = [], ht.trainer.super_step

    def super_step(sb, i, metric_state):
        metric_state, loss = step(sb, i, metric_state)
        losses.append(loss)  # read after the epoch: no sync a step
        return metric_state, loss

    ht.trainer.super_step = super_step
    before = _counted()
    t1 = time.perf_counter()
    try:
        metrics = ht.train()
    finally:
        del ht.trainer.super_step
    run_s = time.perf_counter() - t1
    k1, k1b = (sum(c.values()) for c in _launches(before))
    steps = ht.trainer.state.step
    losses = [float(x) for x in losses]
    if (k1, k1b) != (steps, steps) or steps != HOST_PASSES * HOST_BATCHES:
        raise AssertionError(f"{steps} host-table steps launched K1, K1b {(k1, k1b)}")
    head, tail = np.mean(losses[:HOST_BATCHES]), np.mean(losses[-HOST_BATCHES:])
    if not np.all(np.isfinite(losses)) or not tail < head:
        raise AssertionError(f"the host-table run's loss did not fall: {losses}")
    key, emb = ht._tap
    state = ht.trainer.state
    held = {"cache": _tensor_bytes(emb.embedding), "row_state": _tensor_bytes(state.extra[key]),
            "dense": _tensor_bytes(state.params) + _tensor_bytes(state.opt_state)}
    peak = torch.cuda.max_memory_allocated() - base
    if peak > sum(held.values()) + GB:
        raise AssertionError(f"peak allocation {peak} above {held} + 1 GB")
    return ht, {
        "steps": steps, "k1": k1, "k1b": k1b, "losses": losses,
        "train_auc": metrics.get("auc"), "examples_per_s": metrics["ips"],
        "pass_prep_wait_s": metrics["pass_prep_wait_s"], "init_s": init_s, "run_s": run_s,
        "passes": ht.pass_log, "rows_resident": ht.table.rows_resident,
        "rows_in_ram": ht.table.rows_in_ram, "rows_on_disk": ht.table.rows_on_disk,
        "peak_allocated": peak, "held": held,
    }


def host_table_phase(gp, work: str, seed: int, card: str) -> dict:
    """Phase 37: ``configs/rank/dnn/config_bigdata.yaml`` (vocab 100,000,001,
    26 slots, dim 9 → 8 ids a 128-lane row: 12,500,001 physical host rows;
    bf16 cache, row-wise adagrad with stochastic rounding, batch 8192)
    through ``HostTableTrainer`` with a 1,048,576-row cache (256 MB), a
    file a pass, superbatches and the compact wire, over
    ``write_host_table_data``'s three passes.  The first steps against the
    port's CPU run (``host_first_steps``); a RAM-only leg and a spill leg
    (``host_table_ram_rows`` 500,000, the mmap file under the work
    directory: rows on disk), whose final ``snapshot_rows`` hold the same
    ids; the spill leg's passes replayed into a RAM-only tier
    (``replay_tier``: every pass's rows read and the final rows bitwise, as
    the CPU tests hold the tiers); then ``save``, ``load`` into a fresh
    trainer (the host tier and the dense state bitwise) and one more pass.
    The two legs' values and accumulators are printed, not bounded: they are
    two trainings on the card, which K1b's float atomics do not make
    bitwise reproducible, and in this regime (row-wise adagrad on bf16 rows
    with stochastic rounding, accumulators near 1e-11) a float32 ulp of
    difference grows through the run (``tools_dev/host_leg_drift.py``
    measures how far).  Each leg's per-pass seconds (the
    host table's ``begin_pass``, the upload, the steps, the flush, the wait
    for the next pass's preparation), rows cached and rows in RAM and on
    disk are printed."""
    from paddlerec_tpu_torch.train.host_loop import HostTableTrainer

    t0 = time.perf_counter()
    data = os.path.join(work, "host_table")
    vocab = 100000001
    files = write_host_table_data(data, vocab, seed + 37)
    data_s = time.perf_counter() - t0
    out = {"config": "configs/rank/dnn/config_bigdata.yaml", "vocab": vocab,
           "cache_rows": HOST_CACHE_ROWS, "files": len(files),
           "rows_a_pass": HOST_BATCHES * BIG_BATCH, "data_s": data_s,
           "disk_free_bytes": shutil.disk_usage(work).free}
    t1 = time.perf_counter()
    out["first_steps"] = host_first_steps(host_config(data, seed), files[0], seed)
    out["first_steps"]["seconds"] = time.perf_counter() - t1
    gc.collect()
    ram, out["ram"] = host_leg(host_config(data, seed), seed)
    spill_dir = os.path.join(work, "host_spill")
    spill, out["spill"] = host_leg(host_config(data, seed, **{
        "runner.host_table_ram_rows": HOST_RAM_ROWS,
        "runner.host_table_spill_dir": spill_dir}), seed, record_tier=True)
    if not (spill.table.rows_on_disk > 0 and spill.table.rows_in_ram <= HOST_RAM_ROWS
            < spill.table.rows_resident):
        raise AssertionError(f"the spill leg: {out['spill']['rows_in_ram']} rows in RAM, "
                             f"{out['spill']['rows_on_disk']} on disk")
    t_tier = time.perf_counter()
    out["spill_tier_vs_ram_tier"] = replay_tier(spill.table, spill.tier_log)
    out["spill_tier_vs_ram_tier"]["seconds"] = time.perf_counter() - t_tier
    spill.tier_log = None
    ids_r, vals_r = ram.table.snapshot_rows()
    ids_s, vals_s = spill.table.snapshot_rows()
    same = bool(np.array_equal(ids_r, ids_s))
    out["spill_leg_vs_ram_leg"] = {
        "rows": int(len(ids_r)), "ids_equal": same,
        "max_abs_err": float(np.abs(vals_r - vals_s).max()) if same else None,
        "elements_differing": int((vals_r != vals_s).sum()) if same else None,
        "acc_max_abs_err": float(np.abs(ram.host_acc - spill.host_acc).max()),
        "acc_rows_differing": int((ram.host_acc != spill.host_acc).sum()),
        "spill_file_bytes_on_disk": int(os.stat(os.path.join(
            spill_dir, "table_spill.npy")).st_blocks * 512),
    }
    if not same:
        raise AssertionError(f"the spill leg's rows are not the RAM leg's: "
                             f"{out['spill_leg_vs_ram_leg']}")
    del spill, ids_s, vals_s
    gc.collect()
    shutil.rmtree(spill_dir)  # the spill file takes its full 6.4 GB on some disks

    ckpt = os.path.join(work, "host_ckpt")
    t2 = time.perf_counter()
    ram.save(ckpt, 0)
    save_s = time.perf_counter() - t2
    one = os.path.join(work, "host_one_pass")
    os.makedirs(one)
    shutil.copy(files[1], one)
    fresh = HostTableTrainer(host_config(one, seed))
    t3 = time.perf_counter()
    fresh.load(ckpt, 0)
    load_s = time.perf_counter() - t3
    ids_f, vals_f = fresh.table.snapshot_rows()
    if not (np.array_equal(ids_f, ids_r) and vals_f.tobytes() == vals_r.tobytes()
            and fresh.host_acc.tobytes() == ram.host_acc.tobytes()
            and all(torch.equal(v, fresh.trainer.state.module.state_dict()[k])
                    for k, v in ram.trainer.state.module.state_dict().items())):
        raise AssertionError("the loaded host-table checkpoint differs from the saved state")
    del ram, ids_f, vals_f, ids_r, vals_r
    gc.collect()
    before = _counted()
    t4 = time.perf_counter()
    metrics = fresh.train()
    more_s = time.perf_counter() - t4
    k1, k1b = (sum(c.values()) for c in _launches(before))
    if (k1, k1b) != (HOST_BATCHES, HOST_BATCHES) or not np.isfinite(metrics["auc"]):
        raise AssertionError(f"the pass after load: K1, K1b {(k1, k1b)}, {metrics}")
    out["after_load"] = {"save_s": save_s, "load_s": load_s, "checkpoint_bytes": sum(
        os.path.getsize(f) for f in glob.glob(os.path.join(ckpt, "0", "**"), recursive=True)
        if os.path.isfile(f)), "pass": fresh.pass_log[0], "train_auc": metrics["auc"],
        "run_s": more_s, "k1": k1, "k1b": k1b}
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    for d in (ckpt, one, data):
        shutil.rmtree(d)
    return out


def _staging_count(trainer) -> list:
    """Wraps ``trainer._staged_superbatches`` to count the superbatches it
    copies to the card (the only host → device copies of a superbatch
    feed); returns the one-element counter."""
    staged, inner = [0], trainer._staged_superbatches

    def counted(dataset, k, *args, **kwargs):
        for sb, i in inner(dataset, k, *args, **kwargs):
            if i == 0:
                staged[0] += 1
            yield sb, i
    trainer._staged_superbatches = counted
    return staged


def resident_feed(gp, work: str, seed: int, card: str) -> dict:
    """Phase 38: DeepFM at ``configs/rank/deepfm/config.yaml``'s width (vocab
    1,000,001) at batch 8192 through superbatches of 4 and the compact wire,
    ``RESIDENT_EPOCHS`` epochs with ``feed_device_resident``
    (``run_training``: one K1 and one K1b a step, then ``evaluate()``): the
    train and eval corpora each copied to the card once, every later epoch
    replayed from it, and the bytes held there; then the same run streaming,
    whose last epoch's examples/s (host clock) stands beside the resident
    run's, for information."""
    from paddlerec_tpu_torch.core.config import load_config
    from paddlerec_tpu_torch.train.trainer import Trainer

    cfg0 = load_config(CONFIG)
    vocab = int(cfg0.hyper("sparse_feature_number"))
    data = os.path.join(work, "resident")
    write_train_data(data, TRAIN_STEPS[BIG_BATCH] * BIG_BATCH, vocab, seed + 38)
    extra = {"runner.train_data_dir": data, "runner.test_data_dir": data,
             "runner.model_save_path": None, "runner.infer_load_path": None,
             "runner.epochs": RESIDENT_EPOCHS}
    cfg = train_config(cfg0, work, BIG_BATCH, **extra, **{"runner.feed_device_resident": True})
    trainer = Trainer(cfg)
    trainer.init_state(seed=seed)
    staged = _staging_count(trainer)
    run = run_training(gp, cfg, seed, trainer=trainer)
    entries = {k.split(":")[0]: v for k, v in trainer._resident.items()}
    sbs = TRAIN_STEPS[BIG_BATCH] // 4
    if (set(entries) != {"train", "eval"} or any(len(e["sbs"]) != sbs for e in entries.values())
            or entries["train"]["replays"] != RESIDENT_EPOCHS - 1
            or staged[0] != 2 * sbs):
        raise AssertionError(f"the resident feed staged {staged[0]} superbatches: "
                             f"{ {k: (len(e['sbs'] or []), e['replays']) for k, e in entries.items()} }")
    held = {k: e["bytes"] for k, e in entries.items()}
    del trainer, entries
    gc.collect()
    torch.cuda.empty_cache()
    streaming = Trainer(train_config(cfg0, work, BIG_BATCH, **extra))
    streaming.init_state(seed=seed)
    streamed = _staging_count(streaming)
    before = _counted()
    metrics = streaming.train()
    k1, k1b = (sum(c.values()) for c in _launches(before))
    steps = streaming.state.step
    if (k1, k1b) != (steps, steps) or streamed[0] != RESIDENT_EPOCHS * sbs:
        raise AssertionError(f"the streaming run: K1, K1b {(k1, k1b)} for {steps} steps, "
                             f"{streamed[0]} superbatches staged")
    del streaming
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": "configs/rank/deepfm/config.yaml", "batch_size": BIG_BATCH,
            "epochs": RESIDENT_EPOCHS, "superbatches_staged": staged[0],
            "superbatches_an_epoch": sbs, "host_to_device_copies_after_epoch_0": 0,
            "bytes_on_card": held, "resident": run,
            "examples_per_s_last_epoch": {"resident": run["last_epoch_examples_per_s"],
                                          "streaming": metrics["ips"]},
            "streaming_superbatches_staged": streamed[0], "streaming_k1": k1,
            "streaming_k1b": k1b}


def write_raw_criteo(path: str, rows: int, seed: int) -> None:
    """Raw Criteo TSV (label, 13 integer columns, 26 hex categories, some
    empty), the input of ``native/criteo_parser.cpp``."""
    rng = np.random.RandomState(seed)
    ints = rng.randint(0, 100, (rows, 13)).astype(str)
    ints[rng.rand(rows, 13) < 0.1] = ""
    cats = np.char.mod("%08x", rng.randint(0, 1 << 31, (rows, 26)))
    cats[rng.rand(rows, 26) < 0.05] = ""
    labels = rng.randint(0, 2, rows).astype(str)[:, None]
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in np.hstack([labels, ints, cats])) + "\n")


class _Fallbacks(logging.Handler):
    """Collects the trainer's reader-fallback warnings."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.lines = []

    def emit(self, record):
        if "falling back" in record.getMessage():
            self.lines.append(record.getMessage())


def native_feed(gp, work: str, seed: int, card: str) -> dict:
    """Phase 39: the three ``config_bigdata.yaml`` configs (dnn, deepfm,
    wide_deep; vocab 100,000,001, ``reader_type: native``) read one file of
    ``HOST_BATCHES`` batches of 8192 slot-text rows through
    ``NativeSlotDataset``: no fallback to the Python reader (the run fails on
    one), each config's batches bitwise the Python reader's, and
    ``run_training`` (8 steps, one K1 and one K1b a step, then
    ``evaluate()`` through the same reader).  ``tools.dataset_convert`` turns
    the text into slotbin that ``BinarySlotDataset`` reads back equal;
    ``pipe_command`` runs raw Criteo TSV through the built ``criteo_parser``
    into the same batches as the parser's output read directly.  Prints the
    rows/s of the native parse against the Python reader's."""
    from paddlerec_tpu_torch.core.config import Config, load_config
    from paddlerec_tpu_torch.data.binary import BinarySlotDataset
    from paddlerec_tpu_torch.data.schema import schema_from_config
    from paddlerec_tpu_torch.data.slot_reader import SlotDataset, list_data_files
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
    from paddlerec_tpu_torch.native import build_criteo_parser
    from paddlerec_tpu_torch.native.reader import NativeSlotDataset, parse_file
    from paddlerec_tpu_torch.tools import dataset_convert
    from paddlerec_tpu_torch.train.trainer import Trainer, logger

    text = os.path.join(work, "native_text")
    rows = HOST_BATCHES * BIG_BATCH
    write_criteo_sample(text, num_lines=rows, num_files=1, vocab=100000001, seed=seed + 39)
    files = list_data_files(text)

    def same(a, b) -> bool:
        return len(a) == len(b) and all(
            sorted(x) == sorted(y) and all(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                                           and x[k].tobytes() == y[k].tobytes() for k in x)
            for x, y in zip(a, b))

    out, python_batches, fallbacks = {"rows": rows, "runs": {}}, {}, _Fallbacks()
    logger.addHandler(fallbacks)
    try:
        for model in ("dnn", "deepfm", "wide_deep"):
            cfg = Config({**load_config(BIGDATA.format(model)).to_dict(),
                          "runner.train_data_dir": text, "runner.test_data_dir": text,
                          "runner.model_save_path": None, "runner.infer_load_path": None,
                          "runner.print_interval": 2, "runner.reader_threads": 8,
                          "runner.seed": seed})
            schema = schema_from_config(cfg)
            key = (tuple(schema.sparse_slots), schema.dense_dim)
            if key not in python_batches:
                t0 = time.perf_counter()
                python_batches[key] = list(SlotDataset(files, schema, BIG_BATCH, drop_last=True))
                out["python_reader_rows_per_s"] = rows / (time.perf_counter() - t0)
            trainer = Trainer(cfg)
            trainer.init_state(seed=seed)
            dataset = trainer.make_dataset(text, BIG_BATCH)
            if not isinstance(dataset, NativeSlotDataset):
                raise AssertionError(f"{model}: reader_type native gave {type(dataset)}")
            if not same(list(dataset), python_batches[key]):
                raise AssertionError(f"{model}: the native batches differ from the Python reader's")
            run = run_training(gp, cfg, seed, trainer=trainer, check_fall=False,
                               min_steps=HOST_BATCHES)
            if run["steps"] != HOST_BATCHES:
                raise AssertionError(f"{model}: {run['steps']} steps")
            out["runs"][model] = run
            del trainer, dataset
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(fallbacks)
    if fallbacks.lines:
        raise AssertionError(f"the native reader fell back: {fallbacks.lines}")
    t0 = time.perf_counter()
    parse_file(files[0], SLOTS, 13, num_threads=8)
    out["native_parse_rows_per_s"] = rows / (time.perf_counter() - t0)
    out["native_parse_threads"] = 8

    t0 = time.perf_counter()
    if dataset_convert.main(["-m", BIGDATA.format("dnn"), "--data_dir", text,
                             "--workers", "1", "--threads", "8"]) != 0:
        raise AssertionError("dataset_convert failed")
    out["dataset_convert_s"] = time.perf_counter() - t0
    bins = sorted(glob.glob(os.path.join(text + "_bin", "*.bin")))
    back = list(BinarySlotDataset(bins, BIG_BATCH, drop_last=True))
    (want,) = python_batches.values()
    if len(back) != len(want) or not all(
            np.array_equal(np.asarray(x["sparse"]), y["sparse"])
            and np.asarray(x["label"]).tobytes() == y["label"].tobytes()
            and np.asarray(x["dense"]).tobytes() == y["dense"].tobytes()
            for x, y in zip(back, want)):
        raise AssertionError("the converted slotbin reads back otherwise than the text")

    raw = os.path.join(work, "criteo_raw", "day_0")
    os.makedirs(os.path.dirname(raw))
    write_raw_criteo(raw, BIG_BATCH, seed + 39)
    binary = build_criteo_parser()
    parsed = os.path.join(work, "criteo_parsed")
    with open(raw, "rb") as src, open(parsed, "wb") as dst:
        subprocess.run([binary], stdin=src, stdout=dst, check=True, timeout=120)
    schema = schema_from_config(load_config(BIGDATA.format("dnn")))
    t0 = time.perf_counter()
    piped = list(SlotDataset([raw], schema, 1024, pipe_command=binary))
    pipe_s = time.perf_counter() - t0
    direct = list(SlotDataset([parsed], schema, 1024))
    if not same(piped, direct) or len(piped) != BIG_BATCH // 1024:
        raise AssertionError("pipe_command through criteo_parser differs from its output read "
                             "directly")
    out["pipe_command"] = {"binary": os.path.relpath(binary, ROOT), "rows": BIG_BATCH,
                           "rows_per_s": BIG_BATCH / pipe_s}
    return out


def observability(gp, work: str, seed: int, card: str) -> dict:
    """Phase 40: DeepFM at ``configs/rank/deepfm/config.yaml``'s width, batch
    8192, ``OBS_BATCHES`` steps of ``train()`` with ``profiler_options``
    (batch range [1, 3)) and ``use_visual`` (a scalar line every step), then
    ``evaluate()`` with ``dump_fields`` on the card and on its CPU twin (the
    card's parameters copied): the trace holds K1's kernel, the scalars
    every step, and the two dumps agree through ``diff_report`` (max abs
    diff ≤ 1e-5 on every shared instance, masked rows of the padded tail
    skipped)."""
    from paddlerec_tpu_torch.core.config import load_config
    from paddlerec_tpu_torch.train.trainer import Trainer
    from paddlerec_tpu_torch.utils import profiler
    from paddlerec_tpu_torch.utils.onoff_diff import diff_report

    cfg0 = load_config(CONFIG)
    vocab = int(cfg0.hyper("sparse_feature_number"))
    data = os.path.join(work, "observe")
    rows = OBS_BATCHES * BIG_BATCH + 1000
    write_train_data(data, rows, vocab, seed + 40)
    prof_dir, visual = os.path.join(work, "profile"), os.path.join(work, "visual")
    dumps = {d: os.path.join(work, f"dump_{d}.jsonl") for d in ("cuda", "cpu")}
    cfg = train_config(cfg0, work, BIG_BATCH, **{
        "runner.train_data_dir": data, "runner.test_data_dir": data,
        "runner.model_save_path": None, "runner.infer_load_path": None,
        "runner.print_interval": 1, "runner.use_visual": True,
        "runner.train_visual_path": visual,
        "runner.profiler_options": f"batch_range=[1,3];profile_path={prof_dir};"
                                   "exit_on_finished=false",
        "runner.dump_fields": ["predictions"], "runner.dump_fields_path": dumps["cuda"]})
    profiler.reset()
    trainer = Trainer(cfg)
    trainer.init_state(seed=seed)
    before = _counted()
    metrics = trainer.train()
    profiler.reset()
    steps = trainer.state.step
    scalars = [json.loads(line) for line in open(os.path.join(visual, "scalars.jsonl"))]
    if steps != OBS_BATCHES or [(r["tag"], r["step"]) for r in scalars] != [
            (tag, s) for s in range(1, steps + 1) for tag in ("train/loss", "train/ips")]:
        raise AssertionError(f"use_visual: {steps} steps, scalars {scalars}")
    with open(os.path.join(prof_dir, "trace_1_3.json")) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    k1_names = sorted(n for n in names if "gather_one_kernel" in n or "gather_pool_kernel" in n)
    if not k1_names:
        raise AssertionError("the profiler's trace holds no K1 kernel")
    t0 = time.perf_counter()
    trainer.evaluate()
    eval_s = time.perf_counter() - t0
    k1, k1b = (sum(c.values()) for c in _launches(before))
    if (k1, k1b) != (steps + OBS_BATCHES + 1, steps):
        raise AssertionError(f"phase 40 launched K1, K1b {(k1, k1b)}")
    twin_cfg = cfg.copy()
    twin_cfg["runner.dump_fields_path"] = dumps["cpu"]
    twin = Trainer(twin_cfg, device="cpu")
    twin.init_state(seed=seed)
    twin.state.module.load_state_dict(
        {k: v.cpu() for k, v in trainer.state.module.state_dict().items()})
    twin.evaluate()
    report = diff_report(dumps["cuda"], dumps["cpu"], 1e-5)
    worst = max(v["max_diff"] for v in report["per_var"].values())
    if not report["consistent"] or report["num_shared"] != rows or worst > 1e-5:
        raise AssertionError(f"dump_fields, card against CPU: {report}")
    del trainer, twin
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_auc": metrics.get("auc"), "steps": steps, "scalar_records": len(scalars),
            "trace": os.path.basename(prof_dir) + "/trace_1_3.json", "trace_events": len(names),
            "k1_kernels_in_trace": k1_names,
            "dump": {"instances": report["num_shared"], "max_abs_diff_vs_cpu": worst,
                     "evaluate_s": eval_s},
            "k1": k1, "k1b": k1b}


def host_k1_shapes(rows_cached: int) -> tuple:
    """Phase 41's rows: K1 from the host table's cache view (bf16 into
    float32) at batch 8192, its ids over the rows the first pass cached, and
    K1b into the compact (U·8, 16) buffer of the cache's lane ids."""
    return (
        (K1Shape("host-table cache view (8,388,608 × 16) bf16 into float32, B=8192",
                 HOST_CACHE_ROWS * 8, 16, BIG_BATCH * SLOTS, vocab=8 * rows_cached,
                 dtype="bfloat16"),),
        (K1bShape("host-table cache, compact (U·8, 16), cache vocab 8,388,608, B=8192", 0, 16,
                  BIG_BATCH * SLOTS, ids="compact", vocab=HOST_CACHE_ROWS * 8),),
    )


# the keys at which phases 38-40 launch K1 (rows, D, dtype, N, L) and K1b
# (rows, D, dtype, N): DeepFM's view at 8192, the 10^8 table's bf16 view,
# and K1b's dense DeepFM gradient and the 10^8 compact buffer (rows: 8·U)
DEEPFM_K1 = (125001 * 8, 16, "float32", BIG_BATCH * SLOTS, 1)
BIGDATA_K1 = (12500001 * 8, 16, "bfloat16", BIG_BATCH * SLOTS, 1)
DEEPFM_K1B = (125001 * 8, 16, "float32", BIG_BATCH * SLOTS)


def host_phases(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 37-41: the host-tiered table, the resident feed, the native
    feed, observability, then phase 41, K1 and K1b at the host table's
    cache shapes, each checked against its plain version and timed.  Every
    K1 and K1b launch of phase 37 is at those shapes; those of phases 38-40
    at DeepFM's view and the 10^8 table's (the cases of phases 7 and 10).
    Returns (K1 cases, K1b cases, K1 launches, K1b launches, the launches of
    phases 38-40 by earlier case: ``deepfm_k1``, ``bigdata_k1``)."""
    def lap(phase: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap(phase)

    before = _counted()
    host = host_table_phase(gp, work, seed, card)
    emit({"host_table": host, "card": card})
    k1_host, k1b_host = _launches(before)
    lap("37 host table")
    before = _counted()
    emit({"resident_feed": resident_feed(gp, work, seed, card), "card": card})
    lap("38 resident feed")
    emit({"native_feed": native_feed(gp, work, seed, card), "card": card})
    lap("39 native feed")
    emit({"observability": observability(gp, work, seed, card), "card": card})
    lap("40 observability")
    k1_rest, k1b_rest = _launches(before)
    (k1_shape,), (k1b_shape,) = host_k1_shapes(host["ram"]["passes"][0]["rows_cached"])
    cache_key = (k1_shape.rows, k1_shape.dim, k1_shape.dtype, k1_shape.n, k1_shape.pool)
    if set(k1_host) != {cache_key} or any(k[1:] != (16, "float32", k1b_shape.n)
                                          for k in k1b_host):
        raise AssertionError(f"phase 37 launched K1 {dict(k1_host)}, K1b {dict(k1b_host)}")
    if (set(k1_rest) - {DEEPFM_K1, BIGDATA_K1}
            or any(k != DEEPFM_K1B and k[1:] != (16, "float32", BIG_BATCH * SLOTS)
                   for k in k1b_rest)):
        raise AssertionError(f"phases 38-40 launched K1 {dict(k1_rest)}, K1b {dict(k1b_rest)}")
    k1_cases = time_k1_shapes(gp, (k1_shape,), seed + 41)
    k1b_cases = time_k1b_shapes(gp, (k1b_shape,), seed + 41)
    k1_cases[0]["launches"] = k1_host[cache_key]
    k1b_cases[0]["launches"] = sum(k1b_host.values())
    clock.lap("41 K1/K1b at the host table's shapes")
    k1 = sum(k1_host.values()) + sum(k1_rest.values())
    k1b = sum(k1b_host.values()) + sum(k1b_rest.values())
    return k1_cases, k1b_cases, k1, k1b, {"deepfm_k1": k1_rest.get(DEEPFM_K1, 0),
                                          "bigdata_k1": k1_rest.get(BIGDATA_K1, 0)}


def host_only(gp, seed: int, card: str) -> None:
    """``--only 37-41``: phases 37-41, one JSON line a K1 and a K1b shape,
    and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, k1, k1b, rest = host_phases(gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"host_only": {"k1_launches": k1, "k1b_launches": k1b, **rest,
                        "launch_floor_ms": floor_ms}, "card": card})
    emit(clock.line(card))


# -- K1 at every timed shape (phases 7, 15, 18, 22, 25, 28; ``--only k1``) --
class K1Shape(NamedTuple):
    """One timed lookup of K1: a (rows, dim) table in ``dtype`` read at n
    rows of ``pool`` ids.  ``ids`` as ``_k1_ids``; ``vocab`` bounds uniform
    ids (0: the table's rows); ``library`` is the one PyTorch call that
    computes the same function (``embedding_bag``, ``embedding``), or None."""
    name: str
    rows: int
    dim: int
    n: int
    pool: int = 1
    mode: str = "clip"
    ids: str = "uniform"
    vocab: int = 0
    dtype: str = "float32"
    out_dtype: str = "float32"
    masked: bool = False
    library: Optional[str] = None


# phase 7: DeepFM's packed table through its (R·8, 16) view at the serving
# and the training batch, ffm's unpacked rows and lr's 8-lane view at the
# training batch, and config_bigdata.yaml's bfloat16 table (vocab 10^8)
# through the same view into float32 (the sparse step's external lookup)
MAIN_SHAPES = (
    K1Shape("deepfm view, B=512", 125001 * 8, 16, 512 * SLOTS, vocab=1000001,
            library="embedding_bag"),
    K1Shape("deepfm view, B=8192", 125001 * 8, 16, 8192 * SLOTS, vocab=1000001,
            library="embedding_bag"),
    K1Shape("ffm unpacked rows, B=8192", 1000001, FFM_DIM, 8192 * SLOTS,
            library="embedding_bag"),
    K1Shape("lr 8-lane view, B=8192", 62501 * 16, 8, 8192 * SLOTS, vocab=1000001,
            library="embedding_bag"),
    # no single PyTorch call gives float32 rows from a bfloat16 table
    K1Shape("config_bigdata.yaml bf16 view into float32, B=8192", 12500001 * 8, 16,
            8192 * SLOTS, vocab=100000001, dtype="bfloat16"),
)
# only under --only k1: the Ali-CCP view's B=1024 rows gathered unpooled (the
# same 70,656 random 64-byte rows, one an output row: what the pool costs
# beyond the gather), and an output of N·D > 2^31 elements (8.7 GB), so
# that row offsets past 32 bits are exercised
EXTRA_SHAPES = (
    K1Shape("Ali-CCP view, B=1024's ids unpooled (L=1)", 737952, 16, 1024 * 23 * 3,
            library="embedding_bag"),
    K1Shape("N·D above 2^31 elements", 1000, FFM_DIM, 6_200_000, library="embedding_bag"),
)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def k1_shapes(group: str) -> tuple:
    """The K1 rows of a phase: ``main`` (phase 7), ``seq`` (15), ``rest``
    (18), ``mt`` (22), ``match`` (25), ``graph`` (28), ``tree`` and
    ``movie`` (32), each from the one definition of its shapes."""
    if group == "main":
        return MAIN_SHAPES
    if group in ("match", "tree", "movie"):
        return tuple(K1Shape(name, rows, dim, n, pool, "fill", masked=pool > 1,
                             library="embedding_bag" if pool > 1 else "embedding")
                     for name, rows, dim, n, pool, _ in SLICE_SHAPES.get(group, MATCH_SHAPES))
    if group == "graph":
        return tuple(K1Shape(name, rows, dim, n, mode=mode, ids=kind, library="embedding")
                     for name, rows, dim, n, kind, mode, _ in GRAPH_SHAPES)
    if group in ("seq", "rest"):
        return tuple(K1Shape(name, rows, dim, n, mode="fill", ids=kind, library="embedding")
                     for name, rows, dim, n, kind in (SEQ_SHAPES if group == "seq"
                                                      else REST_SHAPES))
    # MT_SHAPES; K1 as K1b's backward reads a tenth of its ids outside the
    # table (those K1b dropped), and no PyTorch call reads zeros for them
    return tuple(K1Shape(name, rows, dim, n, pool, mode,
                         ids="tenth outside" if mode == "fill_drop" else "uniform",
                         masked=pool > 1,
                         library={"fill": "embedding", "clip": "embedding_bag"}.get(mode))
                 for name, rows, dim, n, pool, mode in MT_SHAPES)


def _k1_ids(shape: K1Shape, g) -> torch.Tensor:
    """(n, pool) int32 ids: ``uniform`` over [0, vocab), ``zeros``,
    ``period P`` (0..P-1 repeated: (B, T) position ids), ``half last`` (as
    ``_fill_ids``), ``tenth outside`` (uniform, a tenth moved past the
    table's end), or ``sorted unique`` (n distinct rows, ascending: the
    touched rows an online delta reads)."""
    if shape.ids in ("zeros", "half last") or shape.ids.startswith("period"):
        return _fill_ids(shape.ids, shape.rows, shape.n, g)
    if shape.ids == "sorted unique":  # a delta's touched rows
        picks = torch.randperm(shape.rows, device="cuda", generator=g)[:shape.n]
        return picks.sort().values.to(torch.int32)[:, None]
    ids = torch.randint(0, shape.vocab or shape.rows, (shape.n, shape.pool), device="cuda",
                        generator=g, dtype=torch.int32)
    if shape.ids == "tenth outside":
        ids = torch.where(torch.rand(ids.shape, device="cuda", generator=g) < 0.1,
                          ids + shape.rows, ids)
    return ids


def k1_check(gp, table, ids, mask, out_dtype, mode: str, chunk_bytes: float = 1 << 30):
    """K1 against ``gather_pool_plain`` on the same inputs, compared in
    chunks of rows (an output can be 8.7 GB).  One id a row: bitwise, NaN
    where the plain version has NaN; a pool: rtol 1e-5 / atol 1e-6 into
    float32 (f32 sums in another order; exact bf16 rows summed in f32),
    rtol 1e-2 / atol 1e-5 into bfloat16 (one rounding of the f32 sum).
    Returns (max_abs_err, ok, tolerance)."""
    out = gp.gather_pool(table, ids, mask, out_dtype, mode=mode)
    torch.cuda.synchronize()
    pool = ids.shape[1]
    tol = ("bitwise" if pool == 1 else
           (1e-5, 1e-6) if out.dtype == torch.float32 else (1e-2, 1e-5))
    step = max(1, int(chunk_bytes // (table.shape[1] * 4 * pool)))
    err, ok = 0.0, True
    for a in range(0, ids.shape[0], step):
        got = out[a:a + step]
        ref = gp.gather_pool_plain(table, ids[a:a + step],
                                   None if mask is None else mask[a:a + step], out_dtype,
                                   mode=mode)
        err = max(err, float((got.float() - ref.float()).nan_to_num().abs().max()))
        if not torch.equal(got.isnan(), ref.isnan()):
            ok = False
        elif tol == "bitwise":
            ok = ok and torch.equal(got.nan_to_num(), ref.nan_to_num())
        else:
            ok = ok and torch.allclose(got.float().nan_to_num(), ref.float().nan_to_num(),
                                       rtol=tol[0], atol=tol[1])
        del ref
    del out
    torch.cuda.synchronize()
    return err, ok, tol if isinstance(tol, str) else {"rtol": tol[0], "atol": tol[1]}


def kernel_libraries(sources, stem: str) -> dict:
    """Build other sources of the kernel ``csrc/<stem>.cu`` with the same C
    interface (a parent commit's, a variant of the current one) with the
    flags of ``build.py``, one ``nvcc`` each, all at once, into a temporary
    directory (removed once they are loaded), and load each as
    ``ops/gather_pool.py`` loads its own.  Returns {file name: library}."""
    import ctypes

    from paddlerec_tpu_torch.ops import build
    from paddlerec_tpu_torch.ops import gather_pool as gp

    work = tempfile.mkdtemp(prefix=f"{stem}_variants_")
    procs = {}
    for i, src in enumerate(sources):
        out = os.path.join(work, f"libvariant{i}.so")
        procs[os.path.basename(src)] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    try:
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            lib = libs[name] = ctypes.CDLL(out)
            for fn, argtypes in gp._ARGTYPES[stem].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.pr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pr_cuda_error_string.restype = ctypes.c_char_p
    finally:
        for _, proc in procs.values():
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return libs


# the timing loops' iterations a shape at most: the whole run's, and those of
# --only k1 / --only k1b, which keep the full counts for kernel work
TIMING_ITERS = 100
K1_ONLY_ITERS, K1B_ONLY_ITERS = 400, 300


def time_k1_shapes(gp, shapes, seed: int, variants=None, cap: int = TIMING_ITERS) -> list:
    """K1 at each of ``shapes``: held against its plain version on the first
    id set (``k1_check``; it raises on a disagreement), then timed with CUDA
    events, the host queued ahead, beside the plain version, the library
    call (which the port never calls) and the byte bound of the same work.
    Uniform ids come in enough distinct sets that a cycle reads more rows
    than L2 holds; ``iters`` stays under the launch queue's depth (see
    ``time_launch_floor``) and is cut for outputs of many MB.

    ``variants`` (label -> library from ``kernel_libraries``): each is checked the
    same way and timed in turns with the current kernel (variant, current,
    current, variant) through the same wrapper, so that both run on one
    card in one call.  ``cap``: the most timed iterations of a shape."""
    from torch.nn import functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    own = gp._lib("gather_pool") if variants else None
    out_rows = []
    for shape in shapes:
        dtype, out_dtype = _DTYPES[shape.dtype], _DTYPES[shape.out_dtype]
        table_es = torch.finfo(dtype).bits // 8
        table = torch.randn(shape.rows, shape.dim, device="cuda", generator=g).to(dtype)
        mask = ((torch.rand(shape.n, shape.pool, device="cuda", generator=g) < 0.7).float()
                if shape.masked else None)
        out_bytes = shape.n * shape.dim * torch.finfo(out_dtype).bits // 8
        n_sets = (max(4, min(64, math.ceil(50e6 / (shape.n * shape.pool
                                                   * max(shape.dim, 16) * table_es))))
                  if shape.ids in ("uniform", "tenth outside", "sorted unique") else 1)
        sets = [_k1_ids(shape, g) for _ in range(n_sets)]
        iters = max(n_sets, min(cap, int(4e9 / out_bytes)))
        err, ok, tol = k1_check(gp, table, sets[0], mask, out_dtype, shape.mode)
        row = {**shape._asdict(), "max_abs_err": err, "ok": ok, "tolerance": tol}
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {row}")
        for label, lib in (variants or {}).items():
            gp._LIBS["gather_pool"] = lib
            try:
                v_err, v_ok, _ = k1_check(gp, table, sets[0], mask, out_dtype, shape.mode)
            finally:
                gp._LIBS["gather_pool"] = own
            if not v_ok:
                raise AssertionError(f"K1 {label} disagrees with the plain version at "
                                     f"{shape.name}: {v_err}")
        uniq = sum(int(torch.unique(s.clamp(0, shape.rows - 1)).numel())
                   for s in sets) / len(sets)
        flat = {id(s): s.reshape(-1).long() for s in sets}
        fns = {
            "ms": lambda s: gp.gather_pool(table, s, mask, out_dtype, mode=shape.mode),
            "plain_ms": lambda s: gp.gather_pool_plain(table, s, mask, out_dtype,
                                                       mode=shape.mode),
        }
        if shape.library == "embedding":
            fns["library_ms"] = lambda s: F.embedding(flat[id(s)], table)
        elif shape.library == "embedding_bag":
            fns["library_ms"] = lambda s: F.embedding_bag(s, table, per_sample_weights=mask,
                                                          mode="sum")
        device, call = _timed(fns, sets, iters)
        device.setdefault("library_ms", None)
        if variants:
            hold = 4 * iters * call["kernel"] + 5
            kernel = fns["ms"]
            device["against"] = {}
            for label, lib in variants.items():
                times = {"variant": [], "current": []}
                for who in ("variant", "current", "current", "variant"):
                    gp._LIBS["gather_pool"] = lib if who == "variant" else own
                    try:
                        times[who].append(time_ms(kernel, sets, iters, hold_ms=hold))
                    finally:
                        gp._LIBS["gather_pool"] = own
                variant_ms, current_ms = (sum(times[k]) / 2 for k in ("variant", "current"))
                device["against"][label] = {"ms": variant_ms, "current_ms": current_ms,
                                            "speedup": variant_ms / current_ms}
        # rows once, ids (and mask) once, output once
        nbytes = (uniq * shape.dim * table_es
                  + shape.n * shape.pool * 4 * (2 if mask is not None else 1) + out_bytes)
        out_rows.append({**row, "touched_rows": uniq, "iters": iters, **device,
                         "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                         shape.n * shape.pool * shape.dim / F32_FLOPS) * 1e3,
                         "bound_by": "bytes", "bytes": nbytes, "call_ms": call,
                         "launches": None})
        del table, mask, sets, flat
        gc.collect()
        torch.cuda.empty_cache()
    return out_rows


def set_share(cases, floor_ms: float) -> None:
    """What a kernel can reach is its byte bound, or the launch floor where
    that is higher: ``share`` = max(bound, floor) / ms."""
    for case in cases:
        case["launch_floor_ms"] = floor_ms
        case["share"] = max(case["bound_ms"], floor_ms) / case["ms"]


def k1_only(gp, seed: int, card: str, against) -> None:
    """``--only k1``: phase 3's K1 checks, then every K1 shape of phases 7,
    15, 18, 22, 25, 28 and 32 (``config_bigdata.yaml``'s view among them) and
    ``EXTRA_SHAPES``, each
    checked and timed by ``time_k1_shapes`` (against the ``--against``
    sources where given), one JSON line a shape."""
    variants = kernel_libraries(against, "gather_pool") if against else {}
    wide = torch.randn(1000001, FFM_DIM, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))
    main_err = check_k1(gp, seed, card, wide)
    del wide
    floor_ms = time_launch_floor(gp)
    shapes = (k1_shapes("main") + k1_shapes("seq") + k1_shapes("rest") + k1_shapes("mt")
              + k1_shapes("match") + k1_shapes("graph") + k1_shapes("tree")
              + k1_shapes("movie") + EXTRA_SHAPES)
    rows = time_k1_shapes(gp, shapes, seed + 9, variants, cap=K1_ONLY_ITERS)
    set_share(rows, floor_ms)
    for row in rows:
        emit({"k1": row, "card": card})
    emit({"k1_only": {"shapes": len(rows), "main_path_max_abs_err": main_err,
                      "launch_floor_ms": floor_ms}, "card": card})



# -- K1b at every timed shape (phases 7, 10, 15, 18, 22, 25, 28; --only k1b) -
class K1bShape(NamedTuple):
    """One timed gradient of K1 (kernel K1b): g (n, dim) in ``g_dtype``
    scattered at (n, pool) ids into a dense (rows, dim) dtable in ``dtype``.
    ``ids`` as ``_k1b_sets``; ``vocab`` bounds uniform ids (0: the table's
    rows; for ``compact`` the vocabulary deduped on the host, and ``rows``
    then follows from the ids); ``library`` is the one PyTorch call that
    computes the same gradient, or None."""
    name: str
    rows: int
    dim: int
    n: int
    pool: int = 1
    mode: str = "clip"
    ids: str = "uniform"
    vocab: int = 0
    g_dtype: str = "float32"
    dtype: str = "float32"
    masked: bool = False
    library: Optional[str] = "embedding_dense_backward"


# phase 7: the gradients of MAIN_SHAPES' lookups (DeepFM's view at both
# batches, its bfloat16 table at the training batch, ffm's unpacked rows,
# lr's 8-lane view); phase 10: the sparse step's compact (U·8, 16) buffer
K1B_MAIN_SHAPES = (
    K1bShape("deepfm view, B=512", 125001 * 8, 16, 512 * SLOTS, vocab=1000001),
    K1bShape("deepfm view, B=8192", 125001 * 8, 16, 8192 * SLOTS, vocab=1000001),
    # the bf16 table's lookup gives bf16 rows, and so its gradient
    K1bShape("deepfm bf16 view, B=8192", 125001 * 8, 16, 8192 * SLOTS, vocab=1000001,
             g_dtype="bfloat16", dtype="bfloat16"),
    K1bShape("ffm unpacked rows, B=8192", 1000001, FFM_DIM, 8192 * SLOTS),
    K1bShape("lr 8-lane view, B=8192", 62501 * 16, 8, 8192 * SLOTS, vocab=1000001),
)
K1B_COMPACT_SHAPES = tuple(
    K1bShape(f"compact (U·8, 16), vocab 10^8, B={b}", 0, 16, b * SLOTS, ids="compact",
             vocab=100000001) for b in BATCHES)
# only under --only k1b: ffm's rows with ids at every residue of r·351 mod 4
# in turn, so that each start of a 1,404-byte row within 16 bytes is taken
# by a quarter of the ids
K1B_EXTRA_SHAPES = (
    K1bShape("ffm unpacked rows, ids at every residue mod 4, B=512", 1000001, FFM_DIM,
             512 * SLOTS, ids="residues"),
)


def k1b_shapes(group: str) -> tuple:
    """The K1b rows of a phase: ``main`` (7), ``compact`` (10), ``seq``
    (15), ``rest`` (18), ``mt`` (22; K1 as K1b's backward is a K1 launch
    only), ``match`` (25), ``graph`` (28), ``tree`` and ``movie`` (32: the
    shapes that are trained), ``extra`` (``--only k1b``)."""
    if group == "main":
        return K1B_MAIN_SHAPES
    if group in ("match", "tree", "movie"):
        return tuple(K1bShape(name, rows, dim, n, pool, "fill", masked=pool > 1,
                              library=("embedding_bag_backward" if pool > 1
                                       else "embedding_dense_backward"))
                     for name, rows, dim, n, pool, trained in SLICE_SHAPES.get(
                         group, MATCH_SHAPES) if trained)
    if group == "graph":
        return tuple(K1bShape(name, rows, dim, n, mode=mode, ids=kind)
                     for name, rows, dim, n, kind, mode, trained in GRAPH_SHAPES if trained)
    if group == "compact":
        return K1B_COMPACT_SHAPES
    if group == "extra":
        return K1B_EXTRA_SHAPES
    if group in ("seq", "rest"):
        return tuple(K1bShape(name, rows, dim, n, mode="fill", ids=kind)
                     for name, rows, dim, n, kind in (SEQ_SHAPES if group == "seq"
                                                      else REST_SHAPES))
    return tuple(K1bShape(name, rows, dim, n, pool, mode, masked=True,
                          library="embedding_bag_backward")
                 for name, rows, dim, n, pool, mode in MT_SHAPES if pool > 1
                 ) + metaheac_k1b_shapes()


def metaheac_k1b_shapes() -> tuple:
    """K1b at each of metaheac's tables as its steps scatter them (phases 19
    and 20): a task's ``SEQ_BATCH`` rows a call, every field its own table of
    ``max_idxs + 1`` rows read in fill mode, a dynamic field's padded span of
    ids unpooled (N = rows × span); tables of one shape share a case."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.models.multitask.metaheac.model import DYNAMIC_SPANS

    md = load_model_def(mt_config("metaheac"))
    fields = collections.defaultdict(list)
    for group, vocabs, spans in (
            ("static", md.static_vocabs, [(0, 1)] * len(md.static_vocabs)),
            ("dynamic", md.dynamic_vocabs, DYNAMIC_SPANS),
            ("ad", md.ad_vocabs, [(0, 1)] * len(md.ad_vocabs))):
        for i, (v, (lo, hi)) in enumerate(zip(vocabs, spans)):
            fields[(v + 1, SEQ_BATCH * (hi - lo))].append(f"{group}_{i}")
    return tuple(K1bShape(f"metaheac {' + '.join(names)}", rows, md.embed_dim, n,
                          mode="fill")
                 for (rows, n), names in sorted(fields.items()))


def _k1b_sets(shape: K1bShape, g, rng) -> tuple:
    """(id sets, rows): (n, pool) int32 ids, ``uniform`` over [0, vocab) in
    enough distinct sets that a cycle through them touches more rows than
    L2 holds, ``zeros``, ``period P`` or ``half last`` (one set, as
    ``_fill_ids``),
    ``residues`` (uniform, id mod 4 = n mod 4), or ``compact`` (the lane
    ids of ``host_dedup``'s slots, the rows one buffer of 8·U for all)."""
    if shape.ids in ("zeros", "half last") or shape.ids.startswith("period"):
        return [_fill_ids(shape.ids, shape.rows, shape.n, g)], shape.rows
    n_sets = max(4, min(64, math.ceil(50e6 / (shape.n * shape.pool * max(shape.dim, 16) * 4))))
    if shape.ids == "compact":
        from paddlerec_tpu_torch.ops.sparse_update import host_dedup

        sets, uniqs = [], []
        for _ in range(n_sets):
            ids = rng.randint(1, shape.vocab, shape.n).astype(np.int64)
            uniq, slot = host_dedup(ids, shape.vocab, 8)
            uniqs.append(int((uniq != np.iinfo(np.int32).max).sum()))
            lane = slot.astype(np.int64) * 8 + ids % shape.vocab % 8
            sets.append(torch.from_numpy(lane.astype(np.int32)).cuda()[:, None])
        return sets, 8 * max(uniqs)
    sets = []
    for _ in range(n_sets):
        ids = torch.randint(0, shape.vocab or shape.rows, (shape.n, shape.pool),
                            device="cuda", generator=g, dtype=torch.int32)
        if shape.ids == "residues":
            quarter = torch.arange(shape.n, device="cuda", dtype=torch.int32)[:, None] % 4
            ids = (ids // 4) * 4 + quarter
            ids = torch.where(ids < shape.rows, ids, ids - 4)
        sets.append(ids)
    return sets, shape.rows


def k1b_check(gp, grad, ids, mask, rows: int, dtype, mode: str):
    """K1b against ``gather_pool_bwd_plain`` on the same inputs: rtol 1e-5
    and atol 1e-6 times the most adds any row takes into float32 (atomics
    add in another order, and a reordered sum's rounding grows with its
    terms), rtol 1e-2 into bfloat16 (one rounding of the f32 sum).
    Returns (max_abs_err, ok, tolerance, the most adds a row takes)."""
    out = gp.gather_pool_bwd(grad, ids, mask, rows, dtype, mode=mode)
    ref = gp.gather_pool_bwd_plain(grad, ids, mask, rows, dtype, mode=mode)
    flat = ids.reshape(-1).long()
    if mode == "fill":
        flat = torch.where(flat < 0, flat + rows, flat)
    adds = int(torch.bincount(flat[(flat >= 0) & (flat < rows)], minlength=1).max())
    tol = (1e-5 if dtype == torch.float32 else 1e-2, 1e-6 * max(1, adds))
    err = float((out.float() - ref.float()).abs().max())
    ok = (out.dtype == ref.dtype and out.shape == ref.shape
          and torch.allclose(out.float(), ref.float(), rtol=tol[0], atol=tol[1]))
    del out, ref
    return err, bool(ok), {"rtol": tol[0], "atol": tol[1]}, adds


@_uncounted
def time_k1b_shapes(gp, shapes, seed: int, variants=None, cap: int = TIMING_ITERS) -> list:
    """K1b at each of ``shapes``: held against its plain version on the first
    id set (``k1b_check``; it raises on a disagreement), then timed with
    CUDA events, the host queued ahead, beside the plain version, the
    library call and ``index_add_`` into zeros (PyTorch's atomic scatter of
    the same sum, at unmasked L = 1; the port calls neither) and the byte
    bound of the same work.  ``iters`` stays under the launch queue's depth
    (see ``time_launch_floor``) and is cut for outputs of many MB.

    ``variants`` (label -> library from ``kernel_libraries``): each is
    checked the same way and timed in turns with the current kernel
    (variant, current, current, variant) through the same wrapper.  ``cap``:
    the most timed iterations of a shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    own = gp._lib("gather_pool_bwd") if variants else None
    out_rows = []
    for shape in shapes:
        g_dtype, dtype = _DTYPES[shape.g_dtype], _DTYPES[shape.dtype]
        sets, rows = _k1b_sets(shape, g, rng)
        grad = torch.randn(shape.n, shape.dim, device="cuda", generator=g).to(g_dtype)
        mask = ((torch.rand(shape.n, shape.pool, device="cuda", generator=g) < 0.7).float()
                if shape.masked else None)
        out_es, g_es = (torch.finfo(t).bits // 8 for t in (dtype, g_dtype))
        out_bytes = rows * shape.dim * out_es
        iters = max(2 * len(sets), min(cap, int(8e9 / out_bytes)))
        err, ok, tol, adds = k1b_check(gp, grad, sets[0], mask, rows, dtype, shape.mode)
        row = {**shape._asdict(), "rows": rows, "max_abs_err": err, "ok": ok,
               "tolerance": tol, "most_adds_per_row": adds}
        if not ok:
            raise AssertionError(f"K1b disagrees with its plain version: {row}")
        for label, lib in (variants or {}).items():
            gp._LIBS["gather_pool_bwd"] = lib
            try:
                v_err, v_ok, _, _ = k1b_check(gp, grad, sets[0], mask, rows, dtype,
                                              shape.mode)
            finally:
                gp._LIBS["gather_pool_bwd"] = own
            if not v_ok:
                raise AssertionError(f"K1b {label} disagrees with the plain version at "
                                     f"{shape.name}: {v_err}")
        uniq = sum(int(torch.unique(s.clamp(0, rows - 1)).numel()) for s in sets) / len(sets)
        flat = {id(s): s.reshape(-1).long() for s in sets}
        fns = {
            "ms": lambda s: gp.gather_pool_bwd(grad, s, mask, rows, dtype, mode=shape.mode),
            "plain_ms": lambda s: gp.gather_pool_bwd_plain(grad, s, mask, rows, dtype,
                                                           mode=shape.mode),
        }
        if shape.library == "embedding_dense_backward":
            fns["library_ms"] = lambda s: torch.ops.aten.embedding_dense_backward(
                grad, flat[id(s)], rows, -1, False)
        elif shape.library == "embedding_bag_backward":
            table = torch.zeros(rows, shape.dim, device="cuda")
            offsets = torch.arange(0, shape.n * shape.pool, shape.pool, device="cuda")
            weights = mask.reshape(-1)
            bags = {id(s): torch.ops.aten._embedding_bag(table, flat[id(s)], offsets, False,
                                                         0, False, weights, False, -1)[1:]
                    for s in sets}
            fns["library_ms"] = lambda s: torch.ops.aten._embedding_bag_backward(
                grad, flat[id(s)], offsets, *bags[id(s)], rows, False, 0, False, weights, -1)
            del table
        if shape.pool == 1 and mask is None and g_dtype == dtype:
            fns["index_add_ms"] = lambda s: torch.zeros(
                rows, shape.dim, dtype=dtype, device="cuda").index_add_(0, flat[id(s)], grad)
        device, call = _timed(fns, sets, iters)
        device.setdefault("library_ms", None)
        device.setdefault("index_add_ms", None)
        if variants:
            hold = 4 * iters * call["kernel"] + 5
            kernel = fns["ms"]
            device["against"] = {}
            for label, lib in variants.items():
                times = {"variant": [], "current": []}
                for who in ("variant", "current", "current", "variant"):
                    gp._LIBS["gather_pool_bwd"] = lib if who == "variant" else own
                    try:
                        times[who].append(time_ms(kernel, sets, iters, hold_ms=hold))
                    finally:
                        gp._LIBS["gather_pool_bwd"] = own
                variant_ms, current_ms = (sum(times[k]) / 2 for k in ("variant", "current"))
                device["against"][label] = {"ms": variant_ms, "current_ms": current_ms,
                                            "speedup": variant_ms / current_ms}
        # the dense gradient written once; g, ids (and mask) read once
        nbytes = (out_bytes + shape.n * shape.dim * g_es
                  + shape.n * shape.pool * 4 * (2 if mask is not None else 1))
        out_rows.append({**row, "touched_rows": uniq, "iters": iters, **device,
                         "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                         shape.n * shape.pool * shape.dim / F32_FLOPS) * 1e3,
                         "bound_by": "bytes", "bytes": nbytes, "zero_fill_bytes": out_bytes,
                         "call_ms": call, "launches": None})
        del sets, flat, grad, mask, fns
        gc.collect()
        torch.cuda.empty_cache()
    return out_rows


def k1b_only(gp, seed: int, card: str, against) -> None:
    """``--only k1b``: phase 3's K1b checks, then every K1b shape of phases
    7, 10, 15, 18, 22, 25, 28 and 32 and ``K1B_EXTRA_SHAPES``, each checked and timed by
    ``time_k1b_shapes`` (against the ``--against`` sources where given), one
    JSON line a shape."""
    variants = kernel_libraries(against, "gather_pool_bwd") if against else {}
    main_err = check_k1b(gp, seed, card)
    floor_ms = time_launch_floor(gp)
    shapes = sum((k1b_shapes(group) for group in
                  ("main", "compact", "seq", "rest", "mt", "match", "graph", "tree", "movie",
                   "extra")), ())
    rows = time_k1b_shapes(gp, shapes, seed + 9, variants, cap=K1B_ONLY_ITERS)
    set_share(rows, floor_ms)
    for row in rows:
        emit({"k1b": row, "card": card})
    emit({"k1b_only": {"shapes": len(rows), "main_path_max_abs_err": main_err,
                       "launch_floor_ms": floor_ms}, "card": card})

def profile_calls(call, iters: int, unit: str) -> dict:
    """``torch.profiler`` over ``iters`` calls of ``call`` (each ending in a
    copy to the host): wall and device time per call, the card's idle share
    of the wall time (profiler on), and the kernels that take the most
    device time; the keys name a call ``unit``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    averages = prof.key_averages()  # parsing the events costs seconds: once
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        f"wall_ms_per_{unit}": wall_ms,
        f"device_ms_per_{unit}": device_ms if kernels else "not measured",
        "device_idle_share": 1 - device_ms / wall_ms if kernels else "not measured",
        f"kernels_per_{unit}": sum(e.count for e in kernels) / iters,
        "top_kernels": [{"name": e.key[:90],
                         f"ms_per_{unit}": e.self_device_time_total / 1e3 / iters,
                         f"calls_per_{unit}": e.count / iters} for e in top],
    }


def profile_forward(model_def, module, batch_size: int, iters: int = 20) -> dict:
    """Phase 8: ``profile_calls`` over ``iters`` DeepFM forwards at one
    batch size."""
    from paddlerec_tpu_torch.core.device import to_tensors

    batch = to_tensors(model_def.example_batch(batch_size), torch.device("cuda"))
    with torch.inference_mode():
        for _ in range(3):
            model_def.infer_forward(module, batch)
        prof = profile_calls(lambda: model_def.infer_forward(module, batch)["predictions"].cpu(),
                             iters, "forward")
    return {"batch_size": batch_size, "forwards": iters, **prof}


# -- phases 42-45: the single-device API and tools, and the all_to_all engine --
API_ROWS = 4096  # phase 42's rows: 8 steps of batch 512
API_EVAL_ROWS = 1024  # phase 43's eval rows: 2 batches of 512
API_BATCH = 512
FI_GROUPS = [[0], [1, 2], [12, 13, 14]]  # phase 43's slot groups
# phase 43: card against CPU AUC; a prediction ~1e-7 apart may fall into the
# next of the AUC's buckets, and one such move changes an AUC of 1,024 rows
# by ~4e-6
FI_ATOL = 1e-4
COMPRESSED_ATOL = 0.02  # phase 42: predictions of the int8 artifact
TIPC_DNN = os.path.join(ROOT, "test_tipc", "configs", "dnn", "train_infer_python.txt")
ENGINE_STEPS = 3  # phase 45: lookups and backwards of the engine
# the launched phases' waits, each at most 3x the phase's seconds (phase 45
# measured 16.8 s, phases 46-47 30.2 s: NVIDIA H100 80GB HBM3, 700 W): the
# launcher stops the ranks at the first, this script waits a little longer
ENGINE_TIMEOUT, MESH_TIMEOUT = 45, 80
ENGINE_LR = 0.1
DEEPFM_512_K1 = (125001 * 8, 16, "float32", API_BATCH * SLOTS, 1)
# phase 44's lookups: dnn's TIPC table (vocab 10,000, dim 8: the 8-lane view
# of 625 packed rows) at the parameter file's batch 16 and the benchmark's 512
TIPC_K1_SHAPES = tuple(
    K1Shape(f"dnn TIPC 8-lane view (10,000 × 8), B={b}", 10000, 8, b * SLOTS,
            library="embedding_bag") for b in (16, API_BATCH))
TIPC_K1B_SHAPES = tuple(
    K1bShape(f"dnn TIPC 8-lane view (10,000 × 8), B={b}", 10000, 8, b * SLOTS)
    for b in (16, API_BATCH))


def _dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(root) for f in fs)


def rank_model_phase(work: str, seed: int, card: str) -> dict:
    """Phase 42: ``RankModel`` on ``configs/rank/deepfm/config.yaml`` at full
    width (vocab 1,000,001, dim 9, towers [512, 256, 128, 32]): train 8
    steps at batch 512 on seeded Criteo rows, evaluate, export, predict,
    compression, then predict from the compressed artifact."""
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
    from paddlerec_tpu_torch.tools.export import load_exported
    from paddlerec_tpu_torch.tools.predict import run_predict
    from paddlerec_tpu_torch.uapi import RankModel

    data = os.path.join(work, "api_data")
    write_criteo_sample(data, num_lines=API_ROWS, num_files=1, vocab=1000001, seed=seed + 42)
    ckpt = os.path.join(work, "api_ckpt")
    model = RankModel(CONFIG, config={
        "runner.train_batch_size": API_BATCH, "runner.infer_batch_size": API_BATCH,
        "runner.epochs": 1, "runner.print_interval": 4, "runner.seed": seed,
        "runner.model_save_path": ckpt, "runner.infer_load_path": ckpt})
    t0 = time.perf_counter()
    train = model.train(dataset=data)
    ev = model.evaluate(weight_path=os.path.join(ckpt, "0"), dataset=data)
    for name, m in (("train", train), ("evaluate", ev)):
        if not (0.0 <= m["auc"] <= 1.0 and math.isfinite(m["auc"])):
            raise AssertionError(f"RankModel {name}: auc {m['auc']}")
    export_dir = os.path.join(work, "api_export")
    model.export(os.path.join(ckpt, "0"), export_dir)
    preds_path = model.predict(os.path.join(ckpt, "0"), data,
                               os.path.join(work, "api_predict"), batch_size=API_BATCH)
    preds = np.loadtxt(preds_path)
    comp = model.compression(os.path.join(ckpt, "0"), os.path.join(work, "api_comp"))
    comp_preds = np.loadtxt(model.infer(comp, data, os.path.join(work, "api_infer_comp"),
                                        batch_size=API_BATCH))
    seconds = time.perf_counter() - t0
    if preds.shape != (API_ROWS,) or not np.all((preds > 0) & (preds < 1)):
        raise AssertionError(f"RankModel.predict gave {preds.shape} predictions")
    # the same artifact on the CPU: the port's twin of the card's predictions
    cpu_preds = np.concatenate(run_predict(export_dir, data, API_BATCH, device="cpu")[0])
    predict_err = float(np.abs(preds - np.round(cpu_preds, 6)).max())
    if predict_err > 2e-6:  # %.6f in the file: one rounding step
        raise AssertionError(f"RankModel.predict against the CPU: {predict_err}")
    # the bound of the int8 table: each element within half a step of its
    # row (scale_r / 2); the predictions within COMPRESSED_ATOL
    quant = np.load(os.path.join(comp, "quantized.npz"))
    with np.load(os.path.join(export_dir, "params.npz")) as z:
        table = z["embedding/embedding"]
    deq = quant["embedding/embedding/q"].astype(np.float32) * \
        quant["embedding/embedding/scale"][:, None]
    step_err = float((np.abs(deq - table) / quant["embedding/embedding/scale"][:, None]).max())
    if step_err > 0.5 + 1e-3:
        raise AssertionError(f"int8 table off by {step_err} steps of its row")
    comp_err = float(np.abs(comp_preds - preds).max())
    if comp_preds.shape != preds.shape or comp_err > COMPRESSED_ATOL:
        raise AssertionError(f"compressed predictions off by {comp_err}")
    _, module = load_exported(comp)  # the dequantized table on the card
    if not torch.equal(module.state_dict()["embedding.embedding"].cpu(),
                       torch.from_numpy(deq)):
        raise AssertionError("load_exported did not dequantize the compressed table")
    del module
    return {"train": train, "evaluate": ev, "rows": API_ROWS, "batch": API_BATCH,
            "artifact_bytes": _dir_bytes(export_dir), "compressed_bytes": _dir_bytes(comp),
            "predict_max_abs_err_vs_cpu": predict_err,
            "int8_table_max_err_in_steps": step_err,
            "compressed_max_abs_err": comp_err, "compressed_bound": COMPRESSED_ATOL,
            "seconds": seconds}


def feature_importance_phase(work: str, seed: int, card: str) -> dict:
    """Phase 43: ``tools.feature_importance`` on phase 42's checkpoint over
    three slot groups of a small eval set, on the card and on the CPU."""
    from paddlerec_tpu_torch.core.config import load_config
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
    from paddlerec_tpu_torch.tools import feature_importance as fi

    data = os.path.join(work, "fi_data")
    write_criteo_sample(data, num_lines=API_EVAL_ROWS, num_files=1, vocab=1000001,
                        seed=seed + 43)
    cfg = load_config(CONFIG, {"runner.test_data_dir": data,
                               "runner.infer_batch_size": API_BATCH,
                               "runner.model_init_path": os.path.join(work, "api_ckpt", "0")})
    t0 = time.perf_counter()
    card_run = fi.run(cfg, FI_GROUPS)
    seconds = time.perf_counter() - t0
    cpu_run = fi.run(cfg, FI_GROUPS, device="cpu")
    err = max(abs(card_run[k] - cpu_run[k]) for k in cpu_run)
    if sorted(card_run) != sorted(cpu_run) or not err <= FI_ATOL:
        raise AssertionError(f"feature importance card {card_run} vs CPU {cpu_run}")
    return {"card": card_run, "cpu": cpu_run, "max_abs_diff": err, "atol": FI_ATOL,
            "groups": FI_GROUPS, "rows": API_EVAL_ROWS, "card_seconds": seconds}


def tipc_phase(work: str, seed: int, card: str) -> dict:
    """Phase 44: TIPC's ``lite_train_lite_infer`` on the dnn parameter file
    over the port's fixture, then ``benchmark_train`` at batch 512 with
    device counts 1 and 2 (2 is above the world: recorded as skipped); the
    records go to a temporary directory."""
    from paddlerec_tpu_torch.tools import tipc

    root = os.path.join(work, "tipc")
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)  # the parameter file's paths are relative: test_tipc/data/...
    try:
        tipc.write_criteo_fixture()
        t0 = time.perf_counter()
        ok = tipc.run_mode(TIPC_DNN, "lite_train_lite_infer", output_dir="out")
        mode_s = time.perf_counter() - t0
        log = open(os.path.join("out", "results_python_lite_train_lite_infer.log")).read()
        if not ok or log.count("Run successfully") != 3:
            raise AssertionError(f"TIPC lite_train_lite_infer failed:\n{log}")
        bench_ok = tipc.run_benchmark(TIPC_DNN, "out", record_dir="records",
                                      matrix_override={"batch_sizes": str(API_BATCH),
                                                       "device_nums": "1|2"})
        record = json.load(open(os.path.join("records", "benchmark_train_dnn.json")))
    finally:
        os.chdir(cwd)
    want_backend = f"cuda:{torch.cuda.get_device_name(0)}"
    if (not bench_ok or record["backend"] != want_backend
            or [(r["batch"], r["devices"]) for r in record["results"]] != [(API_BATCH, 1)]
            or record["skipped"] != [{"devices": 2, "reason": "only 1 devices"}]):
        raise AssertionError(f"TIPC benchmark_train: {record}")
    return {"lite_train_lite_infer_seconds": mode_s, "status_log": log.splitlines(),
            "benchmark": record}


def engine_phase(work: str, seed: int, card: str) -> dict:
    """Phase 45: ``tools.launch --nproc 1 --backend nccl`` runs this script's
    ``engine_rank`` (the all_to_all engine over DeepFM's packed table); its
    result comes back as a file.  The child's failure fails the phase."""
    out = os.path.join(work, "engine")
    os.makedirs(out)
    log_path = os.path.join(out, "rank.log")
    cmd = [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc", "1",
           "--backend", "nccl", "--timeout", str(ENGINE_TIMEOUT), "--", sys.executable,
           os.path.abspath(__file__), "--engine-rank", out, "--seed", str(seed)]
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                            timeout=ENGINE_TIMEOUT + 5).returncode
    if rc != 0:
        raise AssertionError(f"the engine's rank exited {rc}:\n{open(log_path).read()[-6000:]}")
    with open(os.path.join(out, "engine.json")) as f:
        return json.load(f)


def engine_rank(out_dir: str, seed: int) -> int:
    """The launched rank of phase 45: joins the NCCL group (world size 1),
    builds ``ShardedEmbedding`` at mp = 1 over DeepFM's packed table
    (125,001 × 128 float32), and steps it ENGINE_STEPS times at 8192 × 26
    ids (lookup, squared error, backward, SGD), every exchange an NCCL
    ``all_to_all_single``.  The first step's forward is held against the
    plain packed lookup (bitwise) and its gradient against the plain
    version's (rtol 1e-5, atol 1e-6 × the most adds a row takes); the
    overflow count must be 0.  Then K1 and K1b timed on the exchange's own
    ids beside the plain versions, library calls of the same function and
    the byte bound (``time_engine_kernels``).  Writes ``engine.json``."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from paddlerec_tpu_torch.ops import gather_pool as gp
    from paddlerec_tpu_torch.ops.packed_embedding import logical_view
    from paddlerec_tpu_torch.parallel import embedding as emb
    from paddlerec_tpu_torch.parallel.mesh import create_mesh
    from paddlerec_tpu_torch.tools.launch import init_from_env

    device = init_from_env()
    backend = dist.get_backend()
    mesh = create_mesh(1, 1)
    if mesh.mp_group is None or dist.get_world_size() != 1 or backend != "nccl":
        raise AssertionError(f"no NCCL group: {backend}, {mesh}")
    g = torch.Generator(device=device).manual_seed(seed + 45)
    eng = emb.ShardedEmbedding(mesh, 1000001, 9, device=device)
    table = eng.init(g).requires_grad_()
    batches = [torch.randint(0, 1000001, (BIG_BATCH, SLOTS), device=device, generator=g)
               for _ in range(ENGINE_STEPS)]
    targets = [torch.randn(BIG_BATCH, SLOTS, 9, device=device, generator=g)
               for _ in range(ENGINE_STEPS)]
    start = table.detach().clone()
    gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
    gp.gather_pool.launches_by_shape.clear()
    gp.gather_pool_bwd.launches_by_shape.clear()
    overflow, first = [], None
    for ids, tgt in zip(batches, targets):  # the main path: the counted steps
        vecs, ovf = eng.lookup_with_overflow(table, ids)
        ((vecs - tgt) ** 2).sum().backward()
        if first is None:
            first = (vecs.detach().clone(), table.grad.clone())
        with torch.no_grad():
            table -= ENGINE_LR * table.grad
        table.grad = None
        overflow.append(int(ovf))
    torch.cuda.synchronize()
    k1_by = dict(gp.gather_pool.launches_by_shape)
    k1b_by = dict(gp.gather_pool_bwd.launches_by_shape)
    launches = (gp.gather_pool.launches, gp.gather_pool_bwd.launches)
    if any(overflow):
        raise AssertionError(f"the engine dropped ids: {overflow}")
    # the plain packed lookup and its gradient, from the same start
    ref_table = start.clone().requires_grad_()
    flat = (batches[0] % 1000001).reshape(-1, 1).to(torch.int32)
    ref = gp.gather_pool_plain(logical_view(ref_table, 9), flat)[:, :9].reshape(vecs.shape)
    ((ref - targets[0]) ** 2).sum().backward()
    fwd_err = float((first[0] - ref.detach()).abs().max())
    adds = int(torch.bincount(flat.reshape(-1).long() // 8).max())
    tol = {"rtol": 1e-5, "atol": 1e-6 * adds}
    grad_err = float((first[1] - ref_table.grad).abs().max())
    if not torch.equal(first[0], ref.detach()) or not torch.allclose(
            first[1], ref_table.grad, rtol=tol["rtol"], atol=tol["atol"]):
        raise AssertionError(f"the engine against the plain lookup: forward {fwd_err}, "
                             f"gradient {grad_err}")
    cases = time_engine_kernels(gp, eng, table.detach(), batches)
    cases[0]["launches"], cases[1]["launches"] = launches
    result = {"world_size": dist.get_world_size(), "backend": backend,
              "mesh": {"dp": mesh.dp, "mp": mesh.mp},
              "table": list(table.shape), "ids": [BIG_BATCH, SLOTS],
              "capacity": eng.capacity(BIG_BATCH * SLOTS), "steps": ENGINE_STEPS,
              "overflow": overflow, "forward_max_abs_err": fwd_err,
              "grad_max_abs_err": grad_err, "grad_tolerance": tol,
              "k1_launches": launches[0], "k1b_launches": launches[1],
              "k1_by_shape": [[*k, v] for k, v in k1_by.items()],
              "k1b_by_shape": [[*k, v] for k, v in k1b_by.items()],
              "k1": cases[0], "k1b": cases[1]}
    with open(os.path.join(out_dir, "engine.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def time_engine_kernels(gp, eng, table, batches) -> list:
    """K1 (the shard's gather) and K1b (its scatter) at the exchange's own
    ids: each batch's ``(C, 1)`` bucket ids at mp = 1 (sorted unique rows,
    then ``-1`` holes), mode drop.  Each held against its plain version,
    then timed (CUDA events, the host queued ahead) beside the plain version,
    a library call of the same function and the byte bound of what this
    run's ids need.  K1's library call is ``index_select`` over the table
    with a zero row appended, where the holes read.  K1b's is
    ``embedding_dense_backward`` over that padded table with the zero row
    as its ``padding_idx`` (the holes skipped, as the other K1b rows call
    it), beside ``index_add_`` of the valid prefix of ids: never a scatter
    of every hole onto one row, which would time the pile-up, not the
    function."""
    from paddlerec_tpu_torch.parallel import embedding as emb

    rows = table.shape[0]
    cap = eng.capacity(BIG_BATCH * SLOTS)
    sets, touched = [], []
    for ids in batches:
        phys = (ids.reshape(-1).long() % eng.vocab_size) // eng.pack
        uniq, _, _ = emb._dedup_ids(phys, eng.rows)
        send, _, _ = emb._route_ids(uniq, 1, eng.rows_local, cap)
        sets.append(send.reshape(-1, 1))
        touched.append(int((send >= 0).sum()))
    mapped = {id(s): torch.where(s < 0, rows, s).reshape(-1).long() for s in sets}
    valid = {id(s): mapped[id(s)][:t] for s, t in zip(sets, touched)}  # holes come last
    padded = torch.cat([table, table.new_zeros(1, table.shape[1])])
    n, dim = cap, table.shape[1]
    iters = 100
    out = []
    err, ok, tol = k1_check(gp, table, sets[0], None, torch.float32, "drop")
    if not ok:
        raise AssertionError(f"K1 at the engine's ids: {err}")
    device, call = _timed({
        "ms": lambda s: gp.gather_pool(table, s, mode="drop"),
        "plain_ms": lambda s: gp.gather_pool_plain(table, s, mode="drop"),
        "library_ms": lambda s: padded.index_select(0, mapped[id(s)]),
    }, sets, iters)
    uniq = sum(touched) / len(touched)
    nbytes = uniq * dim * 4 + n * 4 + n * dim * 4  # rows, ids, the (C, 128) output
    out.append({"name": "engine shard gather (125,001 × 128), C=319,488 at mp=1, drop",
                "rows": rows, "dim": dim, "dtype": "float32", "n": n, "pool": 1,
                "mode": "drop", "ids": "engine buckets", "touched_rows": uniq,
                "max_abs_err": err, "ok": ok, "tolerance": tol, "iters": iters, **device,
                "library": "index_select", "bound_ms": max(
                    nbytes / HBM_BYTES_PER_S, n * dim / F32_FLOPS) * 1e3,
                "bound_by": "bytes", "bytes": nbytes, "call_ms": call, "launches": None})
    grad = torch.randn(n, dim, device=table.device,
                       generator=torch.Generator(device=table.device).manual_seed(7))
    err, ok, tol, adds = k1b_check(gp, grad, sets[0], None, rows, torch.float32, "drop")
    if not ok:
        raise AssertionError(f"K1b at the engine's ids: {err}")
    device, call = _timed({
        "ms": lambda s: gp.gather_pool_bwd(grad, s, None, rows, mode="drop"),
        "plain_ms": lambda s: gp.gather_pool_bwd_plain(grad, s, None, rows, mode="drop"),
        "library_ms": lambda s: torch.ops.aten.embedding_dense_backward(
            grad, mapped[id(s)], rows + 1, rows, False)[:rows],
        "index_add_ms": lambda s: torch.zeros(rows, dim, device=grad.device).index_add_(
            0, valid[id(s)], grad[:valid[id(s)].numel()]),
    }, sets, iters)
    # the shard's gradient written once (its zeros), the g rows of valid ids
    # and the ids read once: a hole's g row is never needed
    nbytes = rows * dim * 4 + uniq * dim * 4 + n * 4
    out.append({"name": "engine shard scatter (125,001 × 128), C=319,488 at mp=1, drop",
                "rows": rows, "dim": dim, "dtype": "float32", "n": n, "pool": 1,
                "mode": "drop", "ids": "engine buckets", "touched_rows": uniq,
                "max_abs_err": err, "ok": ok, "tolerance": tol, "most_adds_per_row": adds,
                "iters": iters, **device, "library": "embedding_dense_backward",
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, uniq * dim / F32_FLOPS) * 1e3,
                "bound_by": "bytes", "bytes": nbytes, "zero_fill_bytes": rows * dim * 4,
                "call_ms": call, "launches": None})
    return out


def api_parallel_phases(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 42-45: RankModel on DeepFM, feature importance, TIPC and the
    engine through the launcher, then K1 and K1b at TIPC's new shapes.
    Every K1 launch of phases 42-43 is at DeepFM's view at batch 512 (phase
    7's case); every K1 and K1b launch of phase 44 at a ``TIPC_*_SHAPES``
    case.  Returns (K1 cases, K1b cases, K1 launches, K1b launches, the
    engine's result, phase 42-43's K1 launches at DeepFM's case)."""
    def lap(phase: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap(phase)

    before = _counted()
    emit({"rank_model": rank_model_phase(work, seed, card), "card": card})
    lap("42 RankModel")
    emit({"feature_importance": feature_importance_phase(work, seed, card), "card": card})
    lap("43 feature importance")
    k1_api, k1b_api = _launches(before)
    before = _counted()
    emit({"tipc": tipc_phase(work, seed, card), "card": card})
    lap("44 TIPC")
    k1_tipc, k1b_tipc = _launches(before)
    engine = engine_phase(work, seed, card)
    emit({"engine": {k: v for k, v in engine.items() if k not in ("k1", "k1b")},
          "card": card})
    lap("45 engine through the launcher")
    if set(k1_api) != {DEEPFM_512_K1} or set(k1b_api) != {DEEPFM_512_K1[:4]}:
        raise AssertionError(f"phases 42-43 launched K1 {dict(k1_api)}, K1b {dict(k1b_api)}")
    k1_cases = time_k1_shapes(gp, TIPC_K1_SHAPES, seed + 44)
    k1b_cases = time_k1b_shapes(gp, TIPC_K1B_SHAPES, seed + 44)
    for case in k1_cases:
        case["launches"] = k1_tipc.get(
            (case["rows"], case["dim"], case["dtype"], case["n"], case["pool"]), 0)
    for case in k1b_cases:
        case["launches"] = k1b_tipc.get((case["rows"], case["dim"], case["dtype"], case["n"]), 0)
    if (sum(c["launches"] for c in k1_cases) != sum(k1_tipc.values())
            or sum(c["launches"] for c in k1b_cases) != sum(k1b_tipc.values())
            or not all(c["launches"] > 0 for c in k1_cases + k1b_cases)):
        raise AssertionError(f"phase 44 launched K1 {dict(k1_tipc)}, K1b {dict(k1b_tipc)}")
    if engine["k1_launches"] < 1 or engine["k1b_launches"] < 1:
        raise AssertionError(f"the engine launched K1 {engine['k1_launches']}, K1b "
                             f"{engine['k1b_launches']} times")
    clock.lap("45 K1/K1b at TIPC's shapes")
    k1 = sum(k1_api.values()) + sum(k1_tipc.values())
    k1b = sum(k1b_api.values()) + sum(k1b_tipc.values())
    return (k1_cases, k1b_cases, k1, k1b, engine, k1_api[DEEPFM_512_K1])


def api_only(gp, seed: int, card: str) -> None:
    """``--only 42-45``: phases 42-45, one JSON line a K1 and a K1b shape
    (the engine's among them), and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, k1, k1b, engine, deepfm_k1 = api_parallel_phases(
            gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    k1_cases.append(engine["k1"])
    k1b_cases.append(engine["k1b"])
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"api_only": {"k1_launches": k1 + engine["k1_launches"],
                       "k1b_launches": k1b + engine["k1b_launches"],
                       "deepfm_b512_k1": deepfm_k1, "launch_floor_ms": floor_ms},
          "card": card})
    emit(clock.line(card))


# -- phases 46-48: the trainer on a 2x2 mesh of gloo ranks sharing the card --
MESH_DP, MESH_MP = 2, 2
MESH_VOCAB, BIG_MESH_VOCAB = 1000001, 100000001  # config.yaml's, config_bigdata.yaml's
MESH_BATCH, MESH_STEPS = 512, 20  # phase 46: batch a dp row, steps of Trainer.train()
BIG_MESH_BATCH, BIG_MESH_STEPS = 8192, 10  # phase 47
MESH_LABEL = "4 gloo ranks on one card"
MESH_KEEP = 4  # the last steps whose exchange ids rank 0 keeps for phase 48
# phase 46, the 2x2 run against the 1x1 run of the same global batches: float32
# sums in another order (the dp rows' gradients added by an all_reduce, K1b's
# atomics in both runs), kept by Adam's m / sqrt(v) as a relative error: the
# tolerances of the one-device twenty steps against JAX (tests/test_torch_train.py),
# but for the parameters, where a gradient near zero that differs turns into
# an Adam step of another size (up to lr = 1e-3 a step): every element within
# 5e-5 and at most 0.1% of them beyond 1e-5.  Measured: 7.3e-6 (the first run)
MESH_TOL = {"loss": 1e-5, "param": 5e-5, "param_share_beyond_1e-5": 1e-3, "mu": 1e-6,
            "nu": 1e-7}
# phase 47, bf16 with stochastic rounding from the same noise: an element whose
# float32 value moved by a reordered sum may round to its other neighbour, one
# bf16 step away, and keeps that gap while later steps move it towards zero:
# atol one bf16 step of a value near 0.05 (2.44e-4; the table starts
# normal(0, 0.01)) and rtol one step of the value itself.  Measured: 1.22e-4
# (one step of a value in [2^-6, 2^-5)) on a row whose value is now below
# 7.7e-3; loss 4.9e-6; the accumulator (a float32 sum of squares) 5.2e-13
BIG_MESH_TOL = {"table_rtol": 2.0 ** -7, "table_atol": 2.5e-4, "acc_rtol": 1e-3,
                "acc_atol": 1e-9, "loss": 1e-3}


def mesh_config(path: str, data: str, batch: int, dp: int, mp: int, **extra):
    from paddlerec_tpu_torch.core.config import Config, load_config

    flat = dict(load_config(path).to_dict())
    flat.update({"runner.train_data_dir": data, "runner.train_batch_size": batch,
                 "runner.epochs": 1, "runner.print_interval": 5, "runner.reader_type": "",
                 "runner.model_save_path": None, "runner.mesh_dp": dp, "runner.mesh_mp": mp})
    flat.update(extra)
    return Config(flat)


def mesh_phase(work: str, seed: int, card: str) -> dict:
    """Phases 46-47: write the seeded corpora, run ``MESH_DP·MESH_MP`` ranks of
    ``mesh_rank`` through ``tools.launch --backend gloo`` (every rank on the
    one card), then the 1×1 runs of the same global batches in this process
    and the checks of the ranks' results against them.  Returns the ranks'
    results and the phases' numbers."""
    data46, data47 = os.path.join(work, "mesh46"), os.path.join(work, "mesh47")
    write_train_data(data46, MESH_DP * MESH_STEPS * MESH_BATCH, MESH_VOCAB, seed + 46)
    write_sparse_train_data(data47, MESH_DP * BIG_MESH_STEPS * BIG_MESH_BATCH, BIG_MESH_VOCAB,
                            seed + 47)
    out = os.path.join(work, "mesh")
    os.makedirs(out)
    log_path = os.path.join(out, "rank.log")
    cmd = [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc",
           str(MESH_DP * MESH_MP), "--backend", "gloo", "--timeout", str(MESH_TIMEOUT), "--",
           sys.executable, os.path.abspath(__file__), "--mesh-rank", out, "--seed", str(seed)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                            timeout=MESH_TIMEOUT + 10).returncode
    launch_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"a mesh rank exited {rc}:\n{open(log_path).read()[-8000:]}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_DP * MESH_MP)]
    result = {"launch_s": launch_s, "ranks": MESH_DP * MESH_MP, "label": MESH_LABEL,
              "transport": ranks[0]["transport"], "torch": torch.__version__}
    result["46"] = check_mesh_deepfm(ranks, data46, seed)
    emit({"mesh_46": result["46"], "card": card})
    result["47"] = check_mesh_bigdata(ranks, data47, seed)
    emit({"mesh_47": result["47"], "card": card})
    return result


def _global_batches(files, batch: int, steps: int):
    """The global batches a ``MESH_DP``-row mesh reads: dp row i's batch of
    ``shard_files(files, i, MESH_DP)``, the rows concatenated in dp order."""
    from paddlerec_tpu_torch.data.binary import BinarySlotDataset
    from paddlerec_tpu_torch.data.slot_reader import shard_files

    rows = [BinarySlotDataset(shard_files(files, i, MESH_DP), batch)
            for i in range(MESH_DP)]
    out = []
    for parts in zip(*rows):
        out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    if len(out) != steps:
        raise AssertionError(f"{len(out)} global batches, not {steps}")
    return out


@_uncounted
def _one_device(cfg, batches, sparse: bool):
    """The 1×1 trainer of ``cfg`` (its own seed: the mesh's start) stepped on
    ``batches`` on the card; returns (trainer, losses).  A reference the mesh
    runs are held against, not the main path: its launches stay out of the
    by-shape counts."""
    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.train.trainer import Trainer, _count_uniq

    trainer = Trainer(cfg)
    trainer.init_state()
    ms, losses = trainer._init_metric_state(), []
    for b in batches:
        if sparse:
            b = _count_uniq(trainer.model_def.augment_batch_host(b))
        ms, loss = trainer.train_step(to_tensors(b, trainer.device), ms)
        losses.append(loss)
    return trainer, [float(x) for x in losses]


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_mesh_deepfm(ranks, data: str, seed: int) -> dict:
    """Phase 46's checks: every rank's losses, dense leaves, joined table and
    Adam moments after ``Trainer.train()`` against the 1×1 run of the same
    global batches from the same start (``MESH_TOL``), the replicas of each
    shard and of every dense leaf bitwise equal, overflow 0, the resumed
    trainer's state and next loss equal to the trained one's; and the 1×4
    skewed run's overflow and error."""
    from paddlerec_tpu_torch.data.slot_reader import list_data_files

    r46 = [r["46"] for r in ranks]
    batches = _global_batches(list_data_files(data), MESH_BATCH, MESH_STEPS)
    cfg = mesh_config(CONFIG, data, MESH_DP * MESH_BATCH, 1, 1, **{"runner.seed": seed})
    ref, losses = _one_device(cfg, batches, sparse=False)
    want = {k: v.detach() for k, v in ref.state.module.state_dict().items()}
    errs = {"loss": max(abs(a - b) for r in r46 for a, b in zip(r["losses"], losses))}
    sharded = r46[0]["sharded"]
    if sharded != ["embedding.embedding"]:
        raise AssertionError(f"the sharded leaves: {sharded}")
    beyond = total = 0
    for kind in ("param", "mu", "nu"):
        err, worst = 0.0, None
        for k, w in want.items():
            if kind != "param":
                w = ref.state.opt_state[kind][k]
            pick = (lambda r: r["params"][k]) if kind == "param" else (lambda r: r[kind][k])
            got = pick(r46[0]).to(w.device)
            if k in sharded:  # the shards joined, the engine's padding rows cut
                got = torch.cat([pick(r46[j]) for j in range(MESH_MP)]).to(w.device)
                if got.shape[0] != -(-w.shape[0] // MESH_MP) * MESH_MP:
                    raise AssertionError(f"{k}: {tuple(got.shape)} joined, {tuple(w.shape)}")
                got = got[:w.shape[0]]
            if _max_err(got, w) > err:
                err, worst = _max_err(got, w), k
            if kind == "param":
                beyond += int(((got.float() - w.float()).abs() > 1e-5).sum())
                total += w.numel()
        errs[kind], errs[f"{kind}_leaf"] = err, worst
    errs["param_share_beyond_1e-5"] = beyond / total
    for r, out in enumerate(r46):
        for k, v in out["params"].items():
            peer = r46[r % MESH_MP] if k in sharded else r46[0]
            if not torch.equal(v, peer["params"][k]):
                raise AssertionError(f"rank {r}: {k} differs from its replica")
    if (any(e > tol for k, tol in MESH_TOL.items() for e in [errs[k]])
            or any(o["overflow"] for o in r46)
            or not all(o["resumed_equal"] and o["next_loss"] == o["resumed_next_loss"]
                       for o in r46)):
        raise AssertionError(f"phase 46 against the 1x1 run: {errs}, overflow "
                             f"{[o['overflow'] for o in r46]}, resume "
                             f"{[(o['resumed_equal'], o['next_loss'], o['resumed_next_loss']) for o in r46]}")
    skew = [r["46_skew"] for r in ranks]
    if not (skew[0]["total"] > 0 and all(s["total"] == skew[0]["total"] for s in skew)
            and all(s["error"] and "overflowed on 2 consecutive checks" in s["error"]
                    for s in skew)):
        raise AssertionError(f"the 1x4 skewed run: {skew}")
    return {"steps": MESH_STEPS, "batch_per_dp_row": MESH_BATCH, "errors": errs,
            "tolerance": MESH_TOL, "examples_per_s": [o["ips"] for o in r46],
            "exchange_share": [o["exchange_share"] for o in r46],
            "step_ms": [o["step_ms"] for o in r46], "label": MESH_LABEL,
            "skew_overflow": skew[0]["total"], "skew_error": skew[0]["error"],
            "k1_launches": sum(o["k1"] for o in r46),
            "k1b_launches": sum(o["k1b"] for o in r46)}


def check_mesh_bigdata(ranks, data: str, seed: int) -> dict:
    """Phase 47's checks: ``config_bigdata.yaml`` on 2×2 against the 1×1 run
    of the same global batches from the same start and rounding noise: the
    sampled touched rows and every touched row's accumulator within
    ``BIG_MESH_TOL``; each rank found its untouched rows bitwise unchanged;
    the replicas' fingerprints and dense leaves equal."""
    from paddlerec_tpu_torch.data.slot_reader import list_data_files

    r47 = [r["47"] for r in ranks]
    batches = _global_batches(list_data_files(data), BIG_MESH_BATCH, BIG_MESH_STEPS)
    cfg = mesh_config(BIGDATA.format("deepfm"), data, MESH_DP * BIG_MESH_BATCH, 1, 1,
                      **{"runner.seed": seed,
                         "hyper_parameters.sparse_feature_number": BIG_MESH_VOCAB})
    ref, losses = _one_device(cfg, batches, sparse=True)
    table = ref.state.module.embedding.embedding.detach()
    acc = ref.state.extra["embedding/embedding_delta"].acc
    errs = {"loss": max(abs(a - b) for r in r47 for a, b in zip(r["losses"], losses)),
            "table": 0.0, "acc": 0.0}
    ok = errs["loss"] <= BIG_MESH_TOL["loss"]
    touched = 0
    for out in r47[:MESH_MP]:
        rows = out["sample_rows"].to(table.device)
        got, want = out["sample_values"].to(table.device), table[rows]
        errs["table"] = max(errs["table"], _max_err(got, want))
        ok = ok and torch.allclose(got.float(), want.float(), rtol=BIG_MESH_TOL["table_rtol"],
                                   atol=BIG_MESH_TOL["table_atol"])
        rows = out["touched_rows"].to(table.device)
        got, want = out["touched_acc"].to(acc.device), acc[rows]
        errs["acc"] = max(errs["acc"], _max_err(got, want))
        ok = ok and torch.allclose(got, want, rtol=BIG_MESH_TOL["acc_rtol"],
                                   atol=BIG_MESH_TOL["acc_atol"])
        touched += int(rows.numel())
    untouched_ref = int((acc == 0).sum())
    for r, out in enumerate(r47):
        peer = r47[r % MESH_MP]
        ok = ok and out["untouched_unchanged"] and out["fingerprint"] == peer["fingerprint"]
        for k, v in out["dense"].items():
            ok = ok and torch.equal(v, r47[0]["dense"][k])
    if not ok or touched != int((acc > 0).sum()):
        raise AssertionError(f"phase 47 against the 1x1 run: {errs}, touched {touched} against "
                             f"{int((acc > 0).sum())}, untouched "
                             f"{[o['untouched_unchanged'] for o in r47]}, fingerprints "
                             f"{[o['fingerprint'] for o in r47]}")
    del ref
    return {"steps": BIG_MESH_STEPS, "batch_per_dp_row": BIG_MESH_BATCH, "errors": errs,
            "tolerance": BIG_MESH_TOL, "touched_rows": touched,
            "untouched_rows": untouched_ref, "examples_per_s": [o["ips"] for o in r47],
            "label": MESH_LABEL, "rows_local": r47[0]["rows_local"],
            "k1_launches": sum(o["k1"] for o in r47),
            "k1b_launches": sum(o["k1b"] for o in r47)}


def _fingerprint(t: torch.Tensor) -> int:
    """An int64 digest of a tensor's bits (their sum weighted by position),
    taken in blocks of rows."""
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    bits = bits.reshape(bits.shape[0], -1)
    lanes = torch.arange(1, bits.shape[1] + 1, device=t.device, dtype=torch.int64)
    total = 0
    for a in range(0, bits.shape[0], 1 << 18):
        block = bits[a:a + (1 << 18)].long() * lanes
        w = torch.arange(a, a + block.shape[0], device=t.device, dtype=torch.int64) % 1009 + 1
        total += int((block.sum(dim=1) * w).sum())
    return total


def mesh_rank(out_dir: str, seed: int) -> int:
    """A launched rank of phases 46-47 (``tools.launch --backend gloo``, every
    rank on the one card): joins the group, then

    * 46: DeepFM at ``config.yaml``'s width on the 2×2 mesh through
      ``Trainer.train()`` over the seeded slotbin corpus (batch 512 a dp
      row, 20 steps), its K1 and K1b launches counted; its losses, state
      and Adam moments written for the parent's 1×1 comparison; the
      exchange's share of a step over 5 more steps; a trainer resumed from
      the epoch's checkpoint, its state and next loss against the trained
      one's; then 1×4 on skewed ids (every id in shard 0's rows): the
      overflow count and ``overflow_raise_after``'s error;
    * 47: ``config_bigdata.yaml`` (vocab 100,000,001, bf16, row-wise adagrad,
      stochastic rounding) on 2×2 through ``Trainer.train()`` (batch 8192 a
      dp row, 10 steps; the global dedup in the feed), its launches counted;
      the shard's untouched rows checked bitwise against its initial values
      drawn again, a sample of touched rows and every touched row's
      accumulator written, a fingerprint of the shard for the replicas.

    Rank 0 also keeps the exchange's ids (K1's buckets) and the merge's
    slots (K1b) of the last steps of each run for phase 48's timing."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from paddlerec_tpu_torch.core.device import to_tensors
    from paddlerec_tpu_torch.ops import gather_pool as gp
    from paddlerec_tpu_torch.ops import sparse_update as su
    from paddlerec_tpu_torch.ops.packed_embedding import fill_normal
    from paddlerec_tpu_torch.parallel import embedding as emb
    from paddlerec_tpu_torch.tools.launch import init_from_env
    from paddlerec_tpu_torch.train.trainer import Trainer

    device = init_from_env()
    rank = dist.get_rank()
    result = {"transport": f"{dist.get_backend()} on {device.type} tensors"}
    kept = {"k1": [], "merge": []}
    k1, merge = emb.gather_pool, su.gather_pool_bwd

    def keep_k1(table, ids, *args, **kwargs):
        kept["k1"] = (kept["k1"] + [(tuple(table.shape), ids.detach().clone())])[-MESH_KEEP:]
        return k1(table, ids, *args, **kwargs)

    def keep_merge(g, ids, mask, rows, *args, **kwargs):
        kept["merge"] = (kept["merge"] + [(g.detach().clone(), ids.detach().clone(), rows)]
                         )[-MESH_KEEP:]
        return merge(g, ids, mask, rows, *args, **kwargs)

    if rank == 0:
        emb.gather_pool, su.gather_pool_bwd = keep_k1, keep_merge

    def counted(run):
        gp.gather_pool.launches = gp.gather_pool_bwd.launches = 0
        gp.gather_pool.launches_by_shape.clear()
        gp.gather_pool_bwd.launches_by_shape.clear()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            "k1": gp.gather_pool.launches, "k1b": gp.gather_pool_bwd.launches,
            "k1_by_shape": [[*k, v] for k, v in gp.gather_pool.launches_by_shape.items()],
            "k1b_by_shape": [[*k, v] for k, v in gp.gather_pool_bwd.launches_by_shape.items()]}

    # -- 46: DeepFM at config.yaml's width, 2x2 ---------------------------------
    data46 = os.path.join(os.path.dirname(out_dir), "mesh46")
    ckpt = os.path.join(out_dir, "ckpt46")
    cfg = mesh_config(CONFIG, data46, MESH_BATCH, MESH_DP, MESH_MP,
                      **{"runner.seed": seed, "runner.model_save_path": ckpt})
    trainer = Trainer(cfg, device=device)
    losses = []
    step = trainer.train_step

    def recorded(batch, ms):
        ms, loss = step(batch, ms)
        losses.append(loss)
        return ms, loss

    trainer.train_step = recorded
    metrics, seconds, launches = counted(trainer.train)
    trainer.train_step = step
    state = trainer.state
    r46 = {"losses": [float(x) for x in losses], "sharded": sorted(trainer._sharded),
           "params": {k: v.detach().to("cpu", copy=True)
                      for k, v in state.module.state_dict().items()},
           "mu": {k: v.to("cpu", copy=True) for k, v in state.opt_state["mu"].items()},
           "nu": {k: v.to("cpu", copy=True) for k, v in state.opt_state["nu"].items()},
           "overflow": int(metrics.get("embedding_overflow", -1)), "ips": metrics["ips"],
           "seconds": seconds, **launches}
    kept46 = kept["k1"]
    # the exchange's share of a step: 5 more steps with the collectives of
    # the exchange timed between synchronisations
    exchange = [0.0]
    a2a, gather = emb._all_to_all, emb._all_gather

    def synced(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            exchange[0] += time.perf_counter() - t
            return out
        return wrapper

    emb._all_to_all, emb._all_gather = synced(a2a), synced(gather)
    rng = np.random.RandomState(seed + 460)
    extra = {"label": rng.randint(0, 2, MESH_DP * MESH_BATCH).astype(np.float32),
             "sparse": rng.randint(0, MESH_VOCAB, (MESH_DP * MESH_BATCH, SLOTS)),
             "dense": rng.rand(MESH_DP * MESH_BATCH, 13).astype(np.float32)}
    mine = {k: v[trainer.mesh.dp_index * MESH_BATCH:(trainer.mesh.dp_index + 1) * MESH_BATCH]
            for k, v in extra.items()}
    batch = to_tensors(mine, device)
    ms = trainer._init_metric_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        ms, _ = trainer.train_step(batch, ms)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    emb._all_to_all, emb._all_gather = a2a, gather
    r46.update(step_ms=step_s * 1e3, exchange_share=exchange[0] / 5 / step_s)
    # resume from the epoch's checkpoint: the state of the end of train()
    resumed = Trainer(cfg, device=device)
    resumed.load_checkpoint(ckpt, 0)
    got = resumed.state.module.state_dict()
    r46["resumed_equal"] = all(torch.equal(v.cpu(), got[k].cpu())
                               for k, v in r46["params"].items())
    trainer.state.module.load_state_dict({k: v.to(device) for k, v in r46["params"].items()})
    _, loss = trainer.train_step(batch, trainer._init_metric_state())
    _, resumed_loss = resumed.train_step(batch, resumed._init_metric_state())
    r46.update(next_loss=float(loss), resumed_next_loss=float(resumed_loss))
    result["46"] = r46
    del trainer, resumed, state
    # -- 46, then: 1x4 on skewed ids ---------------------------------------------
    skew_cfg = mesh_config(CONFIG, data46, MESH_BATCH, 1, MESH_DP * MESH_MP,
                           **{"runner.seed": seed, "runner.overflow_raise_after": 2})
    skew = Trainer(skew_cfg, device=device)
    skew.init_state()
    rows_local = skew.state.module.embedding.embedding.shape[0]
    rng = np.random.RandomState(seed + 461)
    bad = to_tensors({"label": np.zeros(MESH_BATCH, np.float32),
                      "sparse": rng.randint(0, rows_local * 8, (MESH_BATCH, SLOTS)),
                      "dense": np.zeros((MESH_BATCH, 13), np.float32)}, device)
    ms = skew._init_metric_state()
    ms, _ = skew.train_step(bad, ms)
    skew._check_overflow(ms)
    ms, _ = skew.train_step(bad, ms)
    error = None
    try:
        skew._check_overflow(ms)
    except RuntimeError as e:
        error = str(e)
    result["46_skew"] = {"total": int(skew._global_metrics(ms)["embedding_overflow"]) // 2,
                         "error": error}
    del skew
    torch.cuda.empty_cache()
    # -- 47: config_bigdata.yaml, 2x2 --------------------------------------------
    data47 = os.path.join(os.path.dirname(out_dir), "mesh47")
    big_cfg = mesh_config(BIGDATA.format("deepfm"), data47, BIG_MESH_BATCH, MESH_DP, MESH_MP,
                          **{"runner.seed": seed,
                             "hyper_parameters.sparse_feature_number": BIG_MESH_VOCAB})
    big = Trainer(big_cfg, device=device)
    losses.clear()
    step = big.train_step
    big.train_step = recorded
    metrics, seconds, launches = counted(big.train)
    big.train_step = step
    shard = big.state.module.embedding.embedding.detach()
    acc = big.state.extra["embedding/embedding_delta"].acc
    # the initial shard, drawn again as SlotEmbedding drew it (the generator
    # of runner.seed draws the table first)
    init = torch.empty_like(shard)
    eng = big.state.module.embedding.engine
    fill_normal(init, 1e-2, torch.Generator(device=device).manual_seed(seed),
                rows=-(-BIG_MESH_VOCAB // eng.pack), first=big.mesh.mp_index * eng.rows_local)
    touched = acc > 0
    rows = touched.nonzero()[:, 0]
    lo = big.mesh.mp_index * eng.rows_local
    sample = rows[rows % 64 == 0]
    r47 = {"losses": [float(x) for x in losses], "ips": metrics["ips"], "seconds": seconds,
           "rows_local": int(shard.shape[0]),
           "untouched_unchanged": not bool(((shard != init).any(dim=1) & ~touched).any()),
           "touched_rows": (rows + lo).cpu(), "touched_acc": acc[rows].cpu(),
           "sample_rows": (sample + lo).cpu(), "sample_values": shard[sample].cpu(),
           "fingerprint": _fingerprint(shard) + _fingerprint(acc),
           "dense": {k: v.detach().to("cpu", copy=True)
                     for k, v in big.state.module.state_dict().items()
                     if k != "embedding.embedding"}, **launches}
    result["47"] = r47
    if rank == 0:
        torch.save({"k1_46": kept46, "k1_47": kept["k1"], "merge_47": kept["merge"]},
                   os.path.join(out_dir, "kept.pt"))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


@_uncounted
def time_mesh_kernels(gp, out_dir: str, seed: int) -> tuple:
    """Phase 48: K1 and K1b at the mesh's new shapes, on the ids rank 0 kept
    (the last steps' exchange buckets and merge slots): the shard gather at
    DeepFM's 62,501 float32 rows (phase 46) and the 10^8 table's 6,250,001
    bf16 rows (47), the engine's scatter into DeepFM's shard (46), and the
    row rules' global per-unique merge (47).  Each held against its plain
    version, then timed with CUDA events (the host queued ahead) beside the
    plain version, a library call of the same function and the byte bound
    of what these ids need: valid ids only (the ``-1`` holes of the buckets
    read and add nothing).  Returns (K1 cases, K1b cases)."""
    kept = torch.load(os.path.join(out_dir, "kept.pt"), weights_only=False)
    g = torch.Generator(device="cuda").manual_seed(seed + 48)
    iters = 50
    k1_cases, k1b_cases = [], []
    for key, dtype, run in (("k1_46", torch.float32, "46"), ("k1_47", torch.bfloat16, "47")):
        (rows, dim), _ = kept[key][0]
        sets = [ids.cuda() for _, ids in kept[key]]
        table = (torch.randn(rows, dim, device="cuda", generator=g) * 0.01).to(dtype)
        es = table.element_size()
        padded = torch.cat([table, table.new_zeros(1, dim)])
        mapped = {id(s): torch.where(s < 0, rows, s).reshape(-1).long() for s in sets}
        valid = sum(int((s >= 0).sum()) for s in sets) / len(sets)
        n = sets[0].shape[0]
        err, ok, tol = k1_check(gp, table, sets[0], None, None, "drop")
        if not ok:
            raise AssertionError(f"K1 at the mesh shard ({rows} rows): {err}")
        device, call = _timed({
            "ms": lambda s: gp.gather_pool(table, s, mode="drop"),
            "plain_ms": lambda s: gp.gather_pool_plain(table, s, mode="drop"),
            "library_ms": lambda s: padded.index_select(0, mapped[id(s)]),
        }, sets, iters)
        nbytes = valid * dim * es + n * 4 + n * dim * es
        k1_cases.append({
            "name": f"mesh shard gather ({rows:,} × {dim} {str(dtype)[6:]}), N=mp·C={n:,}, "
                    f"drop (phase {run})", "rows": rows, "dim": dim, "dtype": str(dtype)[6:],
            "n": n, "pool": 1, "mode": "drop", "ids": "mesh buckets", "valid_ids": valid,
            "max_abs_err": err, "ok": ok, "tolerance": tol, "iters": iters, **device,
            "library": "index_select", "bytes": nbytes, "bound_by": "bytes",
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, n * dim / F32_FLOPS) * 1e3,
            "call_ms": call, "phase": run})
        if run == "46":  # the engine's backward: K1b into the shard
            grad = torch.randn(n, dim, device="cuda", generator=g)
            valid_ids = {id(s): mapped[id(s)][mapped[id(s)] < rows] for s in sets}
            valid_g = {id(s): grad[s.reshape(-1) >= 0] for s in sets}
            err, ok, tol, adds = k1b_check(gp, grad, sets[0], None, rows, torch.float32, "drop")
            if not ok:
                raise AssertionError(f"K1b into the mesh shard: {err}")
            device, call = _timed({
                "ms": lambda s: gp.gather_pool_bwd(grad, s, None, rows, mode="drop"),
                "plain_ms": lambda s: gp.gather_pool_bwd_plain(grad, s, None, rows, mode="drop"),
                "library_ms": lambda s: torch.zeros(rows, dim, device="cuda").index_add_(
                    0, valid_ids[id(s)], valid_g[id(s)]),
            }, sets, iters)
            nbytes = rows * dim * 4 + valid * dim * 4 + n * 4
            k1b_cases.append({
                "name": f"mesh shard scatter ({rows:,} × {dim} float32), N=mp·C={n:,}, drop "
                        "(phase 46)", "rows": rows, "dim": dim, "dtype": "float32", "n": n,
                "ids": "mesh buckets", "valid_ids": valid, "max_abs_err": err, "ok": ok,
                "tolerance": tol, "most_adds_per_row": adds, "iters": iters, **device,
                "library": "index_add_", "bytes": nbytes, "bound_by": "bytes",
                "bound_ms": max(nbytes / HBM_BYTES_PER_S, valid * dim / F32_FLOPS) * 1e3,
                "call_ms": call, "phase": "46"})
        del table, padded
    # the global per-unique merge of the row rules (phase 47): this rank's
    # positions' 128-lane gradients summed into the global unique rows
    sets = [(gm.cuda(), ids.cuda(), int(u), ids.reshape(-1).long().cuda())
            for gm, ids, u in kept["merge_47"]]
    gm, ids, u, _ = sets[0]
    n, dim = gm.shape
    err, ok, tol, adds = k1b_check(gp, gm, ids, None, u, torch.float32, "clip")
    if not ok:
        raise AssertionError(f"K1b's global merge: {err}")
    device, call = _timed({
        "ms": lambda s: gp.gather_pool_bwd(s[0], s[1], None, s[2]),
        "plain_ms": lambda s: gp.gather_pool_bwd_plain(s[0], s[1], None, s[2]),
        "library_ms": lambda s: torch.zeros(s[2], dim, device="cuda").index_add_(
            0, s[3], s[0]),
    }, sets, iters)
    rows = sum(s[2] for s in sets) / len(sets)
    nbytes = rows * dim * 4 + n * dim * 4 + n * 4
    k1b_cases.append({
        "name": f"global per-unique merge (U≈{rows:,.0f} × {dim} float32), N={n:,} "
                "(phase 47)", "rows": int(rows), "dim": dim, "dtype": "float32", "n": n,
        "ids": "global slots", "max_abs_err": err, "ok": ok, "tolerance": tol,
        "most_adds_per_row": adds, "iters": iters, **device, "library": "index_add_",
        "bytes": nbytes, "bound_by": "bytes",
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, n * dim / F32_FLOPS) * 1e3,
        "call_ms": call, "phase": "47"})
    return k1_cases, k1b_cases


def mesh_phases(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 46-48: the mesh trainer's runs and their checks, then K1 and
    K1b at the mesh's shapes.  Each case's ``launches`` are the ranks' main
    path's at its shape (K1: the shard's (rows, D, dtype) at N = mp·C; K1b:
    the shard's scatter, or the merges at their N).  Returns (K1 cases, K1b
    cases, K1 launches, K1b launches)."""
    result = mesh_phase(work, seed, card)
    clock.lap("46-47 mesh trainer through the launcher")
    ranks = [torch.load(os.path.join(work, "mesh", f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_DP * MESH_MP)]
    k1_cases, k1b_cases = time_mesh_kernels(gp, os.path.join(work, "mesh"), seed)
    for case in k1_cases:
        case["launches"] = sum(v for r in ranks for k in ("46", "47")
                               for *key, v in r[k]["k1_by_shape"]
                               if (key[0], key[1], key[2], key[4]) == (
                                   case["rows"], case["dim"], case["dtype"], 1))
    k1b_cases[0]["launches"] = sum(v for r in ranks for *key, v in r["46"]["k1b_by_shape"]
                                   if key[0] == k1b_cases[0]["rows"])
    k1b_cases[1]["launches"] = sum(v for r in ranks for *key, v in r["47"]["k1b_by_shape"]
                                   if key[1] == 128 and key[3] == k1b_cases[1]["n"])
    k1 = sum(r[k]["k1"] for r in ranks for k in ("46", "47"))
    k1b = sum(r[k]["k1b"] for r in ranks for k in ("46", "47"))
    if (not all(c["launches"] > 0 for c in k1_cases + k1b_cases)
            or sum(c["launches"] for c in k1_cases) != k1
            or sum(c["launches"] for c in k1b_cases) != k1b):
        raise AssertionError(f"the mesh runs launched K1 {k1}, K1b {k1b} times: "
                             f"{[(c['name'], c['launches']) for c in k1_cases + k1b_cases]}")
    emit({"mesh": {k: v for k, v in result.items() if k not in ("46", "47")}, "card": card})
    clock.lap("48 K1/K1b at the mesh's shapes")
    return k1_cases, k1b_cases, k1, k1b


def mesh_only(gp, seed: int, card: str) -> None:
    """``--only 46-48``: phases 46-48, one JSON line a K1 and a K1b shape,
    and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, k1, k1b = mesh_phases(gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"mesh_only": {"k1_launches": k1, "k1b_launches": k1b, "launch_floor_ms": floor_ms},
          "card": card})
    emit(clock.line(card))


# -- phases 49-51: geo, FL and the online day across processes ----------------
GEO_BATCH, GEO_K = 512, 4  # phase 49: config.yaml's DeepFM at batch 512, k = 4
GEO_FILE_BATCHES = (4, 3, 2)  # batches of each seeded file: rank 0 reads files 0 and 2
FL_ROUNDS = 2  # phase 50: FedAvg rounds of one local epoch, half the clients a round
GEO_KEEP = 4  # the last geo touched-row gathers whose ids rank 0 keeps for timing
ONLINE51_ROWS = 1024  # phase 51: slot_dnn's rows a pass, 16 batches of 32 a dp row
ONLINE51_SPLIT = 720  # minutes a pass: two passes a day
# phases 49-50, the card's ranks against the CPU ranks of the same launch from
# the same start: float32 sums in another order through lazy Adam's
# m / sqrt(v) (MESH_TOL's parameter bars); the replicas bitwise
GEO_TOL = {"param": 5e-5, "param_share_beyond_1e-5": 1e-3}
# phase 51, 2x2 against the 1x1 run of the same global batches: as phase 46
# (plain Adam on slot_dnn's table); the stats, evictions and delta keys exact
ONLINE51_TOL = {"value": 5e-5, "param": 5e-5, "param_share_beyond_1e-5": 1e-3}
# the launches' wait, at most 3x the phases' seconds (45.6 s, the three launches
# together 40.2 s: NVIDIA H100 80GB HBM3, 700 W): the launcher stops their
# ranks at 120 s, this script waits 15 s more
CROSS_TIMEOUT = 120
RANK_GROUP_TIMEOUT = 60  # init_from_env: a rank whose peers hang fails within it


def geo_config(mode: str, data: str, seed: int):
    """``config.yaml``'s DeepFM at full width with ``runner.sync_mode`` ``geo``
    (``GEO_K`` local steps a round) or ``fl`` (``FL_ROUNDS`` rounds, half the
    clients a round)."""
    from paddlerec_tpu_torch.core.config import Config, load_config

    flat = dict(load_config(CONFIG).to_dict())
    flat.update({"runner.train_data_dir": data, "runner.train_batch_size": GEO_BATCH,
                 "runner.epochs": 1, "runner.print_interval": 1000, "runner.reader_type": "",
                 "runner.model_save_path": None, "runner.seed": seed,
                 "runner.sync_mode": mode})
    if mode == "geo":
        flat["runner.geo_k_steps"] = GEO_K
    else:
        # the coordinator's draws from seed + 3: at --seed 0 the plan takes
        # both clients in round 0 and one in round 1
        flat.update({"runner.fl_rounds": FL_ROUNDS, "runner.fl_local_epochs": 1,
                     "runner.fl_client_fraction": 0.5, "runner.seed": seed + 3})
    return Config(flat)


def write_geo_data(data_dir: str, vocab: int, seed: int) -> None:
    """Three slotbin files of ``GEO_FILE_BATCHES`` batches of planted-signal
    rows: the workers' shards are uneven (rank 0 reads files 0 and 2)."""
    from paddlerec_tpu_torch.data.binary import write_slotbin
    from paddlerec_tpu_torch.data.synthetic import synthetic_batch

    os.makedirs(data_dir)
    rng = np.random.RandomState(seed)
    for i, batches in enumerate(GEO_FILE_BATCHES):
        part = synthetic_batch(rng, batches * GEO_BATCH, vocab=vocab)
        write_slotbin(os.path.join(data_dir, f"part-{i}.bin"), part["label"],
                      part["sparse"].astype(np.int32), part["dense"])


def _by_shape(counter) -> list:
    return [[*k, v] for k, v in counter.items()]


def geo_rank(out_dir: str, seed: int, device: str) -> int:
    """A launched rank of phases 49-50 (``tools.launch --nproc 2 --backend
    gloo``; ``device`` cuda, both ranks on the one card, or cpu for the CPU
    run of the same launch).  From the same start (``geo_init.pt``) it trains
    geo through ``Trainer.train()``, then FL through ``FLTrainer.train()``,
    and writes per mode: its steps, each rendezvous' step counts, weights,
    bytes and a fingerprint of its parameters after it, its K1 and K1b
    launches by shape, and its final parameters.  Rank 0 on the card keeps
    the ids of the last geo touched-row gathers for phase 51's timing."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from paddlerec_tpu_torch.ops import embedding as emb_ops
    from paddlerec_tpu_torch.ops import gather_pool as gp
    from paddlerec_tpu_torch.tools.launch import init_from_env
    from paddlerec_tpu_torch.train.fl import FLTrainer
    from paddlerec_tpu_torch.train.trainer import Trainer

    if device == "cpu":
        torch.set_num_threads(2)
    dev = init_from_env(device, timeout_s=RANK_GROUP_TIMEOUT)
    rank = dist.get_rank()
    work = os.path.dirname(out_dir)
    init = torch.load(os.path.join(work, "geo_init.pt"), weights_only=True)
    kept = []
    take_rows = emb_ops.take_rows

    def keep(x, ids, *args, **kwargs):
        if rank == 0 and dev.type == "cuda":
            kept.append((tuple(x.shape), ids.detach().clone()))
            del kept[:-GEO_KEEP]
        return take_rows(x, ids, *args, **kwargs)

    emb_ops.take_rows = keep
    result = {"device": str(dev)}
    for mode in ("geo", "fl"):
        cfg = geo_config(mode, os.path.join(work, "geo_data"), seed)
        trainer = (FLTrainer if mode == "fl" else Trainer)(cfg, device=dev)
        trainer.init_state()
        trainer.state.module.load_state_dict({k: v.to(dev) for k, v in init.items()})
        steps, syncs = [0], []
        step, sync = trainer.train_step, trainer._geo_sync

        def counted(*args, _step=step):
            steps[0] += 1
            return _step(*args)

        def recorded(counts, weights=None, _sync=sync, _t=trainer):
            _sync(counts, weights)
            syncs.append({"counts": np.asarray(counts).tolist(),
                          "weights": None if weights is None else np.asarray(weights).tolist(),
                          "bytes": _t._geo_last_sync_bytes,
                          "fingerprint": sum(_fingerprint(v.reshape(v.shape[0] if v.dim() else 1, -1))
                                             for v in _t.state.module.state_dict().values())})

        trainer.train_step, trainer._geo_sync = counted, recorded
        gp.gather_pool.launches_by_shape.clear()
        gp.gather_pool_bwd.launches_by_shape.clear()
        t0 = time.perf_counter()
        metrics = trainer.train()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        result[mode] = {
            "seconds": time.perf_counter() - t0, "steps": steps[0], "syncs": syncs,
            "max_sync_bytes": trainer._geo_max_sync_bytes,
            "total_ins": metrics.get("total_ins"), "auc": metrics.get("auc"),
            "plan": ([trainer.plan(r).tolist() for r in range(trainer.rounds)]
                     if mode == "fl" else None),
            "k1_by_shape": _by_shape(gp.gather_pool.launches_by_shape),
            "k1b_by_shape": _by_shape(gp.gather_pool_bwd.launches_by_shape)}
        torch.save({k: v.detach().cpu() for k, v in trainer.state.module.state_dict().items()},
                   os.path.join(out_dir, f"{mode}_{rank}.pt"))
        del trainer
    if kept:
        torch.save(kept, os.path.join(out_dir, "kept_geo.pt"))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def online_cross_config(data: str, out: str, seed: int, dp: int, mp: int, batch: int):
    """slot_dnn's config at full width for the online day of phase 51 on a
    ``dp × mp`` mesh (the table sharded over mp), ``batch`` rows a dp row."""
    return online_config(SLOT_DNN, data, out, **{
        "runner.split_interval": ONLINE51_SPLIT, "runner.checkpoint_per_pass": 1,
        "runner.save_first_base": True, "runner.seed": seed,
        "runner.train_batch_size": batch, "runner.infer_batch_size": batch,
        "runner.mesh_dp": dp, "runner.mesh_mp": mp,
        "hyper_parameters.distributed_embedding": int(mp > 1)})


def online_cross_rank(out_dir: str, seed: int) -> int:
    """A launched rank of phase 51 (``tools.launch --nproc 4 --backend gloo``,
    every rank on the one card): slot_dnn's online day on 2×2 through
    ``OnlineTrainer.run()``.  Each delta is checked as it is published: the
    union of the dp rows' touched rows, and rank 0's cube shards against K1's
    gather of those rows from the table gathered whole over mp, bitwise.
    Writes its stats, evictions, shard, delta keys and values (rank 0), K1
    and K1b launches by shape (the delta gathers apart), and rank 0 keeps the
    ids of the engine's last gathers and scatters and of the delta gathers
    for the timing."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from paddlerec_tpu_torch.ops import gather_pool as gp
    from paddlerec_tpu_torch.parallel import embedding as emb
    from paddlerec_tpu_torch.tools.launch import init_from_env
    from paddlerec_tpu_torch.train import online as online_mod

    dev = init_from_env(None, timeout_s=RANK_GROUP_TIMEOUT)
    rank = dist.get_rank()
    work = os.path.dirname(out_dir)
    cfg = online_cross_config(os.path.join(work, "online51"), os.path.join(out_dir, "model"),
                              seed, MESH_DP, MESH_MP, 32)
    trainer = online_mod.OnlineTrainer(cfg, device=dev)
    kept = {"k1": [], "k1b": [], "delta": []}
    k1, k1b, take_rows = emb.gather_pool, emb.gather_pool_bwd, online_mod.take_rows
    deltas = {"launches": 0, "n": [], "exports": 0}
    export_table = online_mod.export_table

    def counted_export(*args, **kwargs):  # a delta table's cube shards written
        deltas["exports"] += 1
        return export_table(*args, **kwargs)

    online_mod.export_table = counted_export

    def keep_k1(table, ids, *args, **kwargs):
        kept["k1"] = (kept["k1"] + [(tuple(table.shape), ids.detach().clone())])[-MESH_KEEP:]
        return k1(table, ids, *args, **kwargs)

    def keep_k1b(g, ids, mask, rows, *args, **kwargs):
        kept["k1b"] = (kept["k1b"] + [(g.detach().clone(), ids.detach().clone(), rows)]
                       )[-MESH_KEEP:]
        return k1b(g, ids, mask, rows, *args, **kwargs)

    def counted_rows(x, ids, *args, **kwargs):
        deltas["launches"] += 1
        deltas["n"].append(int(ids.numel()))
        if rank == 0:
            kept["delta"].append((tuple(x.shape), ids.detach().clone()))
        return take_rows(x, ids, *args, **kwargs)

    if rank == 0:
        emb.gather_pool, emb.gather_pool_bwd = keep_k1, keep_k1b
    online_mod.take_rows = counted_rows
    evicted, published = [], {}
    shrink, save_delta = trainer.shrink, trainer.save_delta
    trainer.shrink = lambda: evicted.append(shrink()) or evicted[-1]

    def checked_delta(save_root, tag):
        masks = {n: trainer._union_touched(m) for n, m in trainer._touched.items()}
        whole = {n: emb._all_gather(t.detach(), trainer.mesh)
                 for n, t in trainer._embedding_entries()}
        path = save_delta(save_root, tag)
        if rank == 0:
            # the delta against K1's gather from the whole tables
            tables = types.SimpleNamespace(_embedding_entries=lambda: list(whole.items()))
            keys, vals, _ = _uncounted(check_cube_delta)(gp, tables, path, masks)
            published[tag] = {n: (keys[n], vals[n]) for n in keys}
        return path

    trainer.save_delta = checked_delta
    gp.gather_pool.launches_by_shape.clear()
    gp.gather_pool_bwd.launches_by_shape.clear()
    t0 = time.perf_counter()
    metrics = trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = trainer.stats["embedding/embedding"]
    shard = trainer.state.module.embedding.embedding.detach()
    torch.save({"seconds": seconds, "auc": metrics.get("auc"), "evicted": evicted,
                "show": torch.from_numpy(st.show.copy()), "seen": torch.from_numpy(st.seen.copy()),
                "unseen_days": torch.from_numpy(st.unseen_days.copy()),
                "shard": shard.cpu(), "mp_index": trainer.mesh.mp_index,
                "sharded": sorted(trainer._sharded), "published": published,
                "delta_launches": deltas["launches"], "delta_n": deltas["n"],
                "delta_exports": deltas["exports"],
                "k1_by_shape": _by_shape(gp.gather_pool.launches_by_shape),
                "k1b_by_shape": _by_shape(gp.gather_pool_bwd.launches_by_shape)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    if rank == 0:
        torch.save(kept, os.path.join(out_dir, "kept.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _launch_ranks(nproc: int, flag: str, out: str, seed: int, extra=()) -> tuple:
    """``tools.launch --nproc N --backend gloo --timeout CROSS_TIMEOUT`` of
    this script's ``flag`` ranks, started without waiting: (process, log)."""
    os.makedirs(out)
    log = open(os.path.join(out, "rank.log"), "w")
    cmd = [sys.executable, "-m", "paddlerec_tpu_torch.tools.launch", "--nproc", str(nproc),
           "--backend", "gloo", "--timeout", str(CROSS_TIMEOUT), "--", sys.executable,
           os.path.abspath(__file__), flag, out, "--seed", str(seed), *extra]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log


def _finish_ranks(proc, log, what: str) -> None:
    try:
        rc = proc.wait(timeout=CROSS_TIMEOUT + 15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "a timeout"
    log.close()
    if rc != 0:
        raise AssertionError(f"the {what} ranks exited {rc}:\n{open(log.name).read()[-8000:]}")


@_uncounted
def _online_one_device(cfg, data: str):
    """Phase 51's reference: the 1×1 ``OnlineTrainer`` on the card (its own
    seed: the mesh's start), fed the global batches of the 2×2 run (dp row
    i's batch of its file shard the i-th part of each).  Not the main path:
    its launches stay out of the counts."""
    from paddlerec_tpu_torch.data.binary import BinarySlotDataset
    from paddlerec_tpu_torch.data.slot_reader import list_data_files, shard_files
    from paddlerec_tpu_torch.train.online import OnlineTrainer

    class Global:
        def __init__(self, dirs):
            self.dirs = dirs

        def __iter__(self):
            for d in self.dirs:
                files = list_data_files(d)
                rows = [BinarySlotDataset([f for f in shard_files(files, i, MESH_DP)
                                           if f.endswith(".bin")], 32)
                        for i in range(MESH_DP)]
                for parts in zip(*rows):
                    yield {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    ref = OnlineTrainer(cfg)
    ref._prepare_pass = lambda dirs, seed: Global(dirs)
    evicted = []
    shrink = ref.shrink
    ref.shrink = lambda: evicted.append(shrink()) or evicted[-1]
    ref.run()
    torch.cuda.synchronize()
    return ref, evicted


def _share_beyond(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.float() - want.float()).abs() > 1e-5).float().mean())


def check_geo_fl(work: str, seed: int) -> dict:
    """Phases 49-50's checks on the ranks' files: see ``cross_phases``."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.data.binary import BinarySlotDataset
    from paddlerec_tpu_torch.data.slot_reader import list_data_files, shard_files
    from paddlerec_tpu_torch.train.touched import batch_rows_by_table

    out = os.path.join(work, "geo")
    card = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    cpu = torch.load(os.path.join(out + "_cpu", "rank0.pt"), weights_only=False)
    init = torch.load(os.path.join(work, "geo_init.pt"), weights_only=True)
    per_rank = (GEO_FILE_BATCHES[0] + GEO_FILE_BATCHES[2], GEO_FILE_BATCHES[1])
    result = {}
    for mode in ("geo", "fl"):
        c0, c1 = (torch.load(os.path.join(out, f"{mode}_{r}.pt"), weights_only=True)
                  for r in range(2))
        twin = torch.load(os.path.join(out + "_cpu", f"{mode}_0.pt"), weights_only=True)
        if not all(torch.equal(c0[k], c1[k]) for k in c0):
            raise AssertionError(f"phase {mode}: the card's ranks' parameters differ")
        syncs = [r[mode]["syncs"] for r in card]
        if any(a["fingerprint"] != b["fingerprint"] for a, b in zip(*syncs)):
            raise AssertionError(f"{mode}: the ranks differ after a rendezvous: {syncs}")
        errs = {"param": max(_max_err(c0[k], twin[k]) for k in c0),
                "param_share_beyond_1e-5": max(_share_beyond(c0[k], twin[k]) for k in c0)}
        twin_syncs = [{k: v for k, v in s.items() if k != "fingerprint"}
                      for s in cpu[mode]["syncs"]]
        if (any(errs[k] > GEO_TOL[k] for k in GEO_TOL)
                or twin_syncs != [{k: v for k, v in s.items() if k != "fingerprint"}
                                  for s in syncs[0]]
                or cpu[mode]["steps"] != card[0][mode]["steps"]):
            raise AssertionError(f"{mode} on the card against its CPU run: {errs}, "
                                 f"{syncs[0]} against {cpu[mode]['syncs']}")
        entry = {"steps": [r[mode]["steps"] for r in card], "rendezvous": len(syncs[0]),
                 "sync_bytes": [s["bytes"] for s in syncs[0]],
                 "max_sync_bytes": card[0][mode]["max_sync_bytes"],
                 "total_ins": card[0][mode]["total_ins"], "auc": card[0][mode]["auc"],
                 "seconds": [r[mode]["seconds"] for r in card], "errors_vs_cpu": errs,
                 "tolerance": GEO_TOL}
        if mode == "geo":
            # every worker trained all its batches; the rows no worker
            # touched keep their initial bits, the touched ones moved
            if entry["steps"] != list(per_rank) or entry["total_ins"] != sum(per_rank) * GEO_BATCH:
                raise AssertionError(f"geo: steps {entry['steps']}, examples "
                                     f"{entry['total_ins']}, not {per_rank}")
            md = load_model_def(geo_config("geo", "", seed))
            table = c0["embedding.embedding"]
            files = list_data_files(os.path.join(work, "geo_data"))
            touched = np.zeros(table.shape[0], bool)
            # each worker's rows a round: the rendezvous ships the dense
            # leaves whole and the largest worker's touched rows (int32 ids
            # and float32 diffs) from every worker
            dense = sum(v.numel() for k, v in c0.items()
                        if k != "embedding.embedding" and v.is_floating_point())
            rounds = []
            for r in range(2):
                batches = list(BinarySlotDataset(shard_files(files, r, 2), GEO_BATCH))
                for i in range(0, len(batches), GEO_K):
                    rows = np.unique(np.concatenate([
                        batch_rows_by_table(md, b, {"embedding/embedding": table.shape[0]})
                        ["embedding/embedding"] for b in batches[i:i + GEO_K]]))
                    touched[rows] = True
                    if len(rounds) <= i // GEO_K:
                        rounds.append([0, 0])
                    rounds[i // GEO_K][r] = len(rows)
            want = [2 * dense * 4 + 2 * max(c) * (4 + table.shape[1] * 4) for c in rounds]
            moved = (table != init["embedding.embedding"]).any(dim=1).numpy()
            if moved[~touched].any() or not moved[touched].mean() > 0.99:
                raise AssertionError(f"geo: {int(moved[~touched].sum())} untouched rows moved, "
                                     f"{float(moved[touched].mean())} of the touched rows")
            entry.update(touched_rows=int(touched.sum()), touched_by_round=rounds,
                         table_bytes=int(table.numel() * table.element_size()))
            if entry["sync_bytes"] != want:
                raise AssertionError(f"geo's rendezvous shipped {entry['sync_bytes']} B, "
                                     f"not {want}")
        else:
            plans = [r["fl"]["plan"] for r in card] + [cpu["fl"]["plan"]]
            for rnd, s in enumerate(syncs[0]):
                chosen = plans[0][rnd]
                want = [per_rank[k] * GEO_BATCH * int(chosen[k]) for k in range(2)]
                weights = np.asarray(want, np.float64) / sum(want)
                if (s["counts"] != want or not np.allclose(s["weights"], weights, atol=1e-7)
                        or not any(chosen)):
                    raise AssertionError(f"fl round {rnd}: {s}, plan {chosen}")
            if any(p != plans[0] for p in plans):
                raise AssertionError(f"fl: the ranks' plans differ: {plans}")
            entry["plan"] = plans[0]
        result[mode] = entry
    return result


def check_online_cross(work: str, seed: int) -> dict:
    """Phase 51's checks on the ranks' files and the 1×1 run: see
    ``cross_phases``."""
    from paddlerec_tpu_torch.native.cube import CubeClient

    out = os.path.join(work, "online51_ranks")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_DP * MESH_MP)]
    root = os.path.join(out, "model")
    ref_root = os.path.join(work, "online51_1x1")
    cfg = online_cross_config(os.path.join(work, "online51"), ref_root, seed, 1, 1,
                              MESH_DP * 32)
    ref, evicted = _online_one_device(cfg, os.path.join(work, "online51"))
    st = ref.stats["embedding/embedding"]
    n = len(st.show)  # the 2x2 table's padding row past it: never shown, never seen
    for r, got in enumerate(ranks):
        for key in ("show", "seen", "unseen_days"):
            ours = got[key].numpy()
            if (ours[:n].tobytes() != getattr(st, key).tobytes()
                    or (key != "unseen_days" and ours[n:].any())):
                raise AssertionError(f"rank {r}: the merged {key} differ from the 1x1 run's")
        if got["evicted"] != evicted or got["sharded"] != ["embedding.embedding"]:
            raise AssertionError(f"rank {r}: evicted {got['evicted']} against {evicted}, "
                                 f"sharded {got['sharded']}")
        peer = ranks[got["mp_index"]]
        if not torch.equal(got["shard"], peer["shard"]):
            raise AssertionError(f"rank {r}: its shard differs from its replica's")
    records, ref_records = _records(root), _records(ref_root)
    exports = [r["delta_exports"] for r in ranks]
    if (records != ref_records or len(records) != len(set(records))
            or exports != [sum(kind == "delta" for *_, kind, _ in records)] + [0] * (len(ranks) - 1)):
        raise AssertionError(f"the donefile: {records} against {ref_records}; the ranks wrote "
                             f"{exports} delta tables")
    errs = {"value": 0.0}
    deltas = [rel for _, _, kind, rel in records if kind == "delta"]
    if sorted(ranks[0]["published"]) != sorted(os.path.basename(d) for d in deltas):
        raise AssertionError(f"rank 0 checked {sorted(ranks[0]['published'])}, not {deltas}")
    for rel in deltas:
        for name, (keys, vals) in ranks[0]["published"][os.path.basename(rel)].items():
            shards = sorted(glob.glob(os.path.join(ref_root, rel, name.replace("/", "_"),
                                                   "cube_shard_*.bin")))
            want_keys = np.sort(np.concatenate([_shard_keys(s) for s in shards]))
            with CubeClient(shards) as client:
                want = client.seek(keys)
            if not np.array_equal(keys, want_keys):
                raise AssertionError(f"{rel}: {len(keys)} keys against the 1x1 run's "
                                     f"{len(want_keys)}")
            errs["value"] = max(errs["value"], float(np.abs(vals - want).max()))
    table = ref.state.module.embedding.embedding.detach()
    joined = torch.cat([ranks[j]["shard"] for j in range(MESH_MP)]).to(table.device)
    joined = joined[:table.shape[0]]
    errs["param"] = _max_err(joined, table)
    errs["param_share_beyond_1e-5"] = _share_beyond(joined, table)
    if any(errs[k] > ONLINE51_TOL[k] for k in ONLINE51_TOL) or not evicted[0] > 0:
        raise AssertionError(f"phase 51 against the 1x1 run: {errs}, evicted {evicted}")
    del ref
    return {"passes": len(deltas), "records": len(records), "evicted": evicted[0],
            "seen_rows": int(st.seen.sum()), "delta_keys": [
                int(sum(len(k) for k, _ in ranks[0]["published"][os.path.basename(d)].values()))
                for d in deltas],
            "errors": errs, "tolerance": ONLINE51_TOL,
            "seconds": [r["seconds"] for r in ranks], "auc": ranks[0]["auc"],
            "delta_launches": [r["delta_launches"] for r in ranks],
            "rows_local": int(ranks[0]["shard"].shape[0])}


@_uncounted
def time_cross_kernels(gp, work: str, seed: int) -> tuple:
    """Phase 51's timing: K1 and K1b at the new shapes of phases 49-51, on
    the ids rank 0 kept: geo's touched-row gather from DeepFM's packed table
    (125,001 × 128, clip, sorted distinct rows), the online day's delta
    gathers from a shard of slot_dnn's table (62,501 × 128, clip) and the
    engine's gather (drop, N = mp·C) and scatter on that shard at batch 32.
    Each held against its plain version, then timed with CUDA events beside
    the plain version, ``index_select`` (``index_add_`` for the scatter) and
    the byte bound of what these ids need.  Returns (K1 cases, K1b cases)."""
    geo = torch.load(os.path.join(work, "geo", "kept_geo.pt"), weights_only=False)
    kept = torch.load(os.path.join(work, "online51_ranks", "kept.pt"), weights_only=False)
    g = torch.Generator(device="cuda").manual_seed(seed + 51)
    iters = 50
    k1_cases, k1b_cases = [], []
    for what, mode, entries in (("geo touched-row gather", "clip", geo),
                                ("online delta gather from a shard", "clip", kept["delta"]),
                                ("online engine shard gather", "drop", kept["k1"])):
        (rows, dim), _ = entries[-1]
        sets = [ids.cuda().reshape(-1, 1).to(torch.int32) for _, ids in entries]
        table = torch.randn(rows, dim, device="cuda", generator=g) * 0.01
        padded = torch.cat([table, table.new_zeros(1, dim)])
        mapped = {id(s): torch.where(s < 0, rows, s).reshape(-1).long() for s in sets}
        valid = sum(int((s >= 0).sum()) for s in sets) / len(sets)
        n = sum(s.shape[0] for s in sets) / len(sets)
        err, ok, tol = k1_check(gp, table, sets[-1], None, None, mode)
        if not ok:
            raise AssertionError(f"K1, {what} ({rows} rows): {err}")
        device, call = _timed({
            "ms": lambda s: gp.gather_pool(table, s, mode=mode),
            "plain_ms": lambda s: gp.gather_pool_plain(table, s, mode=mode),
            "library_ms": lambda s: padded.index_select(0, mapped[id(s)]),
        }, sets, iters)
        nbytes = valid * dim * 4 + n * 4 + n * dim * 4
        k1_cases.append({
            "name": f"{what} ({rows:,} × {dim} float32), N≈{n:,.0f}, {mode} (phases 49-51)",
            "rows": rows, "dim": dim, "dtype": "float32", "n": int(round(n)), "pool": 1,
            "mode": mode, "ids": what, "valid_ids": valid, "max_abs_err": err, "ok": ok,
            "tolerance": tol, "iters": iters, **device, "library": "index_select",
            "bytes": nbytes, "bound_by": "bytes",
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, n * dim / F32_FLOPS) * 1e3,
            "call_ms": call, "phase": "49" if what.startswith("geo") else "51"})
        del table, padded
    sets = [(gm.cuda(), ids.cuda(), int(r)) for gm, ids, r in kept["k1b"]]
    gm, ids, rows = sets[-1]
    n, dim = gm.shape
    err, ok, tol, adds = k1b_check(gp, gm, ids, None, rows, torch.float32, "drop")
    if not ok:
        raise AssertionError(f"K1b, the online engine's scatter: {err}")
    valid_ids = {id(s): s[1].reshape(-1).long()[s[1].reshape(-1) >= 0] for s in sets}
    valid_g = {id(s): s[0][s[1].reshape(-1) >= 0] for s in sets}
    device, call = _timed({
        "ms": lambda s: gp.gather_pool_bwd(s[0], s[1], None, s[2], mode="drop"),
        "plain_ms": lambda s: gp.gather_pool_bwd_plain(s[0], s[1], None, s[2], mode="drop"),
        "library_ms": lambda s: torch.zeros(s[2], dim, device="cuda").index_add_(
            0, valid_ids[id(s)], valid_g[id(s)]),
    }, sets, iters)
    valid = sum(int((s[1] >= 0).sum()) for s in sets) / len(sets)
    nbytes = rows * dim * 4 + valid * dim * 4 + n * 4
    k1b_cases.append({
        "name": f"online engine shard scatter ({rows:,} × {dim} float32), N=mp·C={n:,}, "
                "drop (phase 51)", "rows": rows, "dim": dim, "dtype": "float32", "n": n,
        "ids": "mesh buckets", "valid_ids": valid, "max_abs_err": err, "ok": ok,
        "tolerance": tol, "most_adds_per_row": adds, "iters": iters, **device,
        "library": "index_add_", "bytes": nbytes, "bound_by": "bytes",
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, valid * dim / F32_FLOPS) * 1e3,
        "call_ms": call, "phase": "51"})
    return k1_cases, k1b_cases


def cross_phases(gp, work: str, seed: int, card: str, clock: PhaseClock) -> tuple:
    """Phases 49-51, their launches started together (each through
    ``tools.launch --backend gloo --timeout``, its ranks joining with a
    ``RANK_GROUP_TIMEOUT`` s group timeout):

    * 49: ``config.yaml``'s DeepFM at full width, ``sync_mode: geo`` with k =
      ``GEO_K`` at batch 512, 2 ranks on the card over uneven shards (three
      seeded files: 6 and 3 batches), and the same launch on the CPU, both
      from one start (``geo_init.pt``): every worker trained all its batches,
      every rank's parameters bitwise equal after each rendezvous, the rows
      no worker touched at their initial bits, the rendezvous bytes, the
      card against the CPU run (``GEO_TOL``) and the same rendezvous;
    * 50: the same ranks, ``sync_mode: fl``, ``FL_ROUNDS`` rounds, half the
      clients a round: the plan the same on every rank, the weights the
      chosen clients' example counts over their sum, the ranks bitwise equal
      after each round, the card against the CPU run;
    * 51: slot_dnn's online day of two passes on 2×2 (4 ranks on the card,
      the table sharded over mp): each delta the union of the dp rows'
      touched rows and rank 0's shards K1's gather of them from the table
      gathered whole, the merged stats and shrink's evictions the same on
      every rank and the 1×1 run's, the donefile written once, the shards'
      replicas bitwise equal, deltas and table against the 1×1 run of the
      same global batches (``ONLINE51_TOL``).

    Then K1 and K1b at the new shapes (``time_cross_kernels``).  Returns (K1
    cases, K1b cases, the DeepFM view's K1 and K1b launches at B=512 of the
    geo ranks, K1 launches, K1b launches, the phases' numbers)."""
    from paddlerec_tpu_torch.core.registry import load_model_def
    from paddlerec_tpu_torch.train.trainer import Trainer

    vocab = MESH_VOCAB
    write_geo_data(os.path.join(work, "geo_data"), vocab, seed + 49)
    write_online_day(os.path.join(work, "online51"), ONLINE51_SPLIT,
                     lambda d, s: write_train_data(d, ONLINE51_ROWS, vocab, s), seed + 51)
    init = Trainer(geo_config("geo", "", seed))
    init.init_state()
    torch.save({k: v.detach().cpu() for k, v in init.state.module.state_dict().items()},
               os.path.join(work, "geo_init.pt"))
    del init
    t0 = time.perf_counter()
    launches = [
        (_launch_ranks(2, "--geo-rank", os.path.join(work, "geo"), seed), "geo card"),
        (_launch_ranks(2, "--geo-rank", os.path.join(work, "geo_cpu"), seed,
                       ("--rank-device", "cpu")), "geo CPU"),
        (_launch_ranks(MESH_DP * MESH_MP, "--online-rank", os.path.join(work, "online51_ranks"),
                       seed), "online 2x2"),
    ]
    for (proc, log), what in launches:
        _finish_ranks(proc, log, what)
    launch_s = time.perf_counter() - t0
    geo = check_geo_fl(work, seed)
    emit({"geo_49": geo["geo"], "card": card})
    emit({"fl_50": geo["fl"], "card": card})
    online = check_online_cross(work, seed)
    online["launch_s"] = launch_s
    emit({"online_51": online, "card": card})
    clock.lap("49-51 geo, FL, the online day across processes")
    k1_cases, k1b_cases = time_cross_kernels(gp, work, seed)
    # the launches of the ranks' main path, by shape: the geo ranks' DeepFM
    # view (phase 7's B=512 rows) and touched-row gathers, the online ranks'
    # engine gathers, delta gathers and scatters
    card_ranks = [torch.load(os.path.join(work, "geo", f"rank{r}.pt"), weights_only=False)
                  for r in range(2)]
    online_ranks = [torch.load(os.path.join(work, "online51_ranks", f"rank{r}.pt"),
                               weights_only=False) for r in range(MESH_DP * MESH_MP)]
    view_k1 = view_k1b = geo_k1 = 0
    view = (-(-vocab // 8) * 8, 16, "float32", GEO_BATCH * SLOTS)
    for r in card_ranks:
        for mode in ("geo", "fl"):
            for *key, v in r[mode]["k1_by_shape"]:
                if tuple(key) == (*view, 1):
                    view_k1 += v
                elif tuple(key[:3]) == (k1_cases[0]["rows"], 128, "float32") and key[4] == 1:
                    geo_k1 += v
                else:
                    raise AssertionError(f"a geo rank launched K1 at {key}")
            for *key, v in r[mode]["k1b_by_shape"]:
                if tuple(key) != view:
                    raise AssertionError(f"a geo rank launched K1b at {key}")
                view_k1b += v
    shard_k1 = sum(v for r in online_ranks for *key, v in r["k1_by_shape"])
    delta_k1 = sum(r["delta_launches"] for r in online_ranks)
    engine_k1b = sum(v for r in online_ranks for *key, v in r["k1b_by_shape"])
    if any(tuple(key[:3]) != (online["rows_local"], 128, "float32")
           for r in online_ranks for *key, _ in r["k1_by_shape"] + r["k1b_by_shape"]):
        raise AssertionError("an online rank launched a kernel off its shard")
    k1_cases[0]["launches"], k1_cases[1]["launches"] = geo_k1, delta_k1
    k1_cases[2]["launches"] = shard_k1 - delta_k1
    k1b_cases[0]["launches"] = engine_k1b
    if not (view_k1 > 0 and view_k1b > 0
            and all(c["launches"] > 0 for c in k1_cases + k1b_cases)):
        raise AssertionError(f"phases 49-51 launched K1 at the view {view_k1}, K1b {view_k1b}, "
                             f"{[(c['name'], c['launches']) for c in k1_cases + k1b_cases]}")
    clock.lap("49-51 K1/K1b at their shapes")
    return (k1_cases, k1b_cases, view_k1, view_k1b, view_k1 + shard_k1 + geo_k1,
            view_k1b + engine_k1b, {"geo": geo, "online": online})


def cross_only(gp, seed: int, card: str) -> None:
    """``--only 49-51``: phases 49-51, one JSON line a K1 and a K1b shape,
    and the phases' seconds."""
    clock = PhaseClock()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        k1_cases, k1b_cases, view_k1, view_k1b, k1, k1b, _ = cross_phases(
            gp, work, seed, card, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor_ms = time_launch_floor(gp)
    set_share(k1_cases, floor_ms)
    set_share(k1b_cases, floor_ms)
    for row in k1_cases:
        emit({"k1": row, "card": card})
    for row in k1b_cases:
        emit({"k1b": row, "card": card})
    emit({"cross_only": {"k1_launches": k1, "k1b_launches": k1b,
                         "deepfm_view_b512_k1": view_k1, "deepfm_view_b512_k1b": view_k1b,
                         "launch_floor_ms": floor_ms}, "card": card})
    emit(clock.line(card))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("k1", "k1b", "29-32", "33-36", "37-41", "42-45",
                                           "46-48", "49-51"),
                        help="k1 (k1b): phases 1-2, K1's (K1b's) checks of phase 3, then "
                             "that kernel checked and timed at every shape; 29-32 (33-36, "
                             "37-41, 42-45, 46-48, 49-51): phases 1-2 and 29-32 (33-36, "
                             "37-41, 42-45, 46-48, 49-51) (default: every phase)")
    # the launched ranks of phase 45, phases 46-47 and phases 49-51
    # (tools.launch sets their group up): not for users
    parser.add_argument("--engine-rank", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-rank", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--geo-rank", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--online-rank", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--rank-device", default="cuda", choices=("cuda", "cpu"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--against", action="append", default=[], metavar="SOURCE.cu",
                        help="with --only: another source of that kernel with the same C "
                             "interface, built and timed in turns with the current one")
    args = parser.parse_args(argv)
    if args.against and args.only not in ("k1", "k1b"):
        parser.error("--against needs --only k1 or --only k1b")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.engine_rank:
        return engine_rank(args.engine_rank, args.seed)
    if args.mesh_rank:
        return mesh_rank(args.mesh_rank, args.seed)
    if args.geo_rank:
        return geo_rank(args.geo_rank, args.seed, args.rank_device)
    if args.online_rank:
        return online_cross_rank(args.online_rank, args.seed)
    sys.path.insert(0, ROOT)
    from paddlerec_tpu_torch.core.config import load_config
    from paddlerec_tpu_torch.data.schema import schema_from_config
    from paddlerec_tpu_torch.data.slot_reader import SlotDataset, list_data_files
    from paddlerec_tpu_torch.data.synthetic import write_criteo_sample
    from paddlerec_tpu_torch.ops import build
    from paddlerec_tpu_torch.ops import gather_pool as gp
    from paddlerec_tpu_torch.serving.webserver import RecClient, RecService
    from paddlerec_tpu_torch.tools.export import export_model
    from paddlerec_tpu_torch.tools.predict import run_predict

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    clock = PhaseClock()
    card = card_line()
    print(card, flush=True)  # phase 1

    t0 = time.perf_counter()  # phase 2
    libs = build.build()
    emit({"build": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "seconds": time.perf_counter() - t0, "card": card})
    if args.only:
        if args.only in ("k1", "k1b"):
            (k1_only if args.only == "k1" else k1b_only)(gp, args.seed, card, args.against)
        elif args.only == "29-32":
            slice_only(gp, args.seed, card)
        elif args.only == "33-36":
            online_only(gp, args.seed, card)
        elif args.only == "37-41":
            host_only(gp, args.seed, card)
        elif args.only == "42-45":
            api_only(gp, args.seed, card)
        elif args.only == "46-48":
            mesh_only(gp, args.seed, card)
        else:
            cross_only(gp, args.seed, card)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # ffm's unpacked table, for the checks and the timing at its shape
    wide = torch.randn(1000001, FFM_DIM, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(args.seed))
    main_err = check_k1(gp, args.seed, card, wide)  # phase 3
    bwd_err = check_k1b(gp, args.seed, card)
    sparse_checks(gp, args.seed, card)  # phase 9, the part at small size
    gp.gather_pool_bwd.launches_by_shape.clear()  # from here: the main path's K1b launches
    clock.lap("1-3 card, build, kernel checks")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:  # phase 4
        cfg = load_config(CONFIG)
        vocab = int(cfg.hyper("sparse_feature_number"))
        export_dir, data_dir = os.path.join(work, "export"), os.path.join(work, "data")
        export_model(cfg, export_dir, seed=args.seed)
        write_criteo_sample(data_dir, num_lines=ROWS, num_files=4, vocab=vocab,
                            seed=args.seed)
        cpu_out, _ = run_predict(export_dir, data_dir, BATCHES[-1], device="cpu")
        cpu_preds = np.concatenate(cpu_out)
        if cpu_preds.shape != (ROWS,):
            raise AssertionError(f"CPU run gave {cpu_preds.shape} predictions")
        launches, reports, cuda_preds = {}, {}, {}
        for batch in BATCHES:
            gp.gather_pool.launches = 0
            out, report = run_predict(export_dir, data_dir, batch)
            launches[batch] = gp.gather_pool.launches
            forwards = math.ceil(ROWS / batch)
            if launches[batch] != forwards:
                raise AssertionError(
                    f"batch {batch}: {launches[batch]} K1 launches for "
                    f"{forwards} forwards")
            preds = cuda_preds[batch] = np.concatenate(out)
            if preds.shape != (ROWS,) or not np.all((preds > 0) & (preds < 1)):
                raise AssertionError(f"batch {batch}: predictions not in (0, 1)")
            err = float(np.abs(preds - cpu_preds).max())
            if err > 1e-5:
                raise AssertionError(f"batch {batch}: cuda vs cpu max err {err}")
            reports[batch] = dict(report, max_abs_err_vs_cpu=err,
                                  k1_launches=launches[batch])
            emit({"predict": {"batch_size": batch, **reports[batch]}, "card": card})
        clock.lap("4 predict")

        gp.gather_pool.launches = 0  # phase 5
        service = RecService(export_dir)
        server = service.run_web_service(port=0, background=True)
        try:
            client = RecClient("127.0.0.1", server.server_address[1])
            dataset = SlotDataset(list_data_files(data_dir),
                                  schema_from_config(cfg), 64)
            answers = client.predict_batches(dataset, limit=3)
        finally:
            server.shutdown()
            server.server_close()
        launches["serve"] = gp.gather_pool.launches
        got = np.concatenate([a["result"]["predictions"] for a in answers])
        serve_err = float(np.abs(got - cuda_preds[BATCHES[0]][:got.shape[0]]).max())
        if len(answers) != 3 or got.shape != (192,) or serve_err > 1e-5:
            raise AssertionError(f"served answers disagree: {serve_err}")
        if launches["serve"] != 4:  # the warm-up and three requests
            raise AssertionError(f"serving made {launches['serve']} K1 launches")
        emit({"serve": {"requests": 3, "rows": int(got.shape[0]),
                        "max_abs_err_vs_predict": serve_err,
                        "k1_launches": launches["serve"]}, "card": card})
        clock.lap("5 serve")

        train_cfgs, train_runs = {}, {}  # phase 6
        for batch in reversed(BATCHES):
            write_train_data(os.path.join(work, f"train_{batch}"),
                             TRAIN_STEPS[batch] * batch, vocab, args.seed + batch)
            train_cfgs[batch] = train_config(cfg, work, batch)
        first = first_steps_vs_cpu(gp, train_cfgs[BATCHES[-1]], args.seed)
        emit({"train_first_steps_vs_cpu": first, "card": card})
        for batch in reversed(BATCHES):
            train_runs[batch] = run_training(gp, train_cfgs[batch], args.seed)
            emit({"train": train_runs[batch], "card": card})
        bf16_cfg = train_config(
            cfg, work, BATCHES[-1], **{
                "hyper_parameters.sparse_feature_dtype": "bfloat16",
                "runner.epochs": 1,
                "runner.model_save_path": os.path.join(work, "ckpt_bf16"),
                "runner.infer_load_path": os.path.join(work, "ckpt_bf16")})
        train_runs["bf16"] = run_training(gp, bf16_cfg, args.seed, check_fall=False)
        emit({"train": train_runs["bf16"], "card": card})
        clock.lap("6 train")

        # phase 7: DeepFM's view at both batches; the zoo's shapes at the
        # training batch: ffm's unpacked rows, and the 8-lane view of a
        # width-1 table (lr, ffm's first_weight); config_bigdata.yaml's bf16
        # view (K1); DeepFM's bf16 table (K1b)
        main_cases = time_k1_shapes(gp, k1_shapes("main"), args.seed + 1)
        cases, zoo_cases, big_cases = main_cases[:2], main_cases[2:4], main_cases[4:]
        main_bwd = time_k1b_shapes(gp, k1b_shapes("main"), args.seed + 3)
        bwd_cases, bf16_bwd_cases, zoo_bwd_cases = main_bwd[:2], main_bwd[2:3], main_bwd[3:]
        del wide
        clock.lap("7 time K1/K1b")
        for batch in BATCHES:  # phase 8
            emit({"profile": profile_forward(service.model_def, service.module, batch),
                  "card": card})
        for batch in BATCHES:
            emit({"profile_train": profile_train(train_cfgs[batch], batch, args.seed),
                  "card": card})
        floor_ms = time_launch_floor(gp)
        del service
        clock.lap("8 profile")
        sparse = train_sparse(gp, work, args.seed, card)  # phase 9
        clock.lap("9 sparse")
        from paddlerec_tpu_torch.core.config import Config  # phase 10
        bigdata = load_config(BIGDATA.format("deepfm")).to_dict()
        for batch in BATCHES:
            sparse_cfg = Config({**bigdata, "runner.train_batch_size": batch,
                                 "runner.infer_batch_size": batch,
                                 "hyper_parameters.sparse_feature_number": vocab})
            emit({"profile_train_sparse": profile_train(sparse_cfg, batch, args.seed),
                  "card": card})
        big_vocab = int(bigdata["hyper_parameters.sparse_feature_number"])
        emit({"time_dedup": time_dedup(args.seed, (big_vocab, vocab)), "card": card})
        compact_cases = time_k1b_shapes(gp, k1b_shapes("compact"), args.seed + 5)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("10 sparse profile, dedup")
        zoo = ctr_zoo(gp, args.seed, card)  # phase 11
        clock.lap("11 zoo")
        paths = zoo_paths(gp, work, data_dir, ROWS, zoo["seeds"], card)  # phase 12
        for model in ("dcn_v2", "xdeepfm"):
            emit({"profile_train": profile_train(
                train_config(zoo_config(model), work, BATCHES[-1]), BATCHES[-1],
                args.seed, iters=5), "card": card})
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("12 zoo paths")
        seq = twin_zoo(gp, args.seed, card, SEQ, "seq_zoo")  # phase 13
        clock.lap("13 seq zoo")
        seq_runs = seq_paths(gp, work, args.seed, card)  # phase 14
        clock.lap("14 seq paths")
        seq_cases = time_k1_shapes(gp, k1_shapes("seq"), args.seed + 13)  # phase 15
        seq_bwd_cases = time_k1b_shapes(gp, k1b_shapes("seq"), args.seed + 13)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("15 seq shapes")
        rest = twin_zoo(gp, args.seed, card, REST, "rank_rest_zoo")  # phase 16
        clock.lap("16 rank rest zoo")
        rest_runs = rank_rest_paths(gp, work, args.seed, card)  # phase 17
        clock.lap("17 rank rest paths")
        check_fill_shapes(gp, args.seed + 18, card, REST_SHAPES)  # phase 18
        rest_cases = time_k1_shapes(gp, k1_shapes("rest"), args.seed + 18)
        rest_bwd_cases = time_k1b_shapes(gp, k1b_shapes("rest"), args.seed + 18)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("18 rank rest shapes")
        mt = multitask_zoo(gp, args.seed, card)  # phase 19
        clock.lap("19 multitask zoo")
        mt_runs = multitask_paths(gp, work, args.seed, card)  # phase 20
        clock.lap("20 multitask paths")
        check_second_order(gp, args.seed + 21, card)  # phase 21
        check_multitask_shapes(gp, args.seed + 22, card)  # phase 22
        mt_cases = time_k1_shapes(gp, k1_shapes("mt"), args.seed + 22)
        mt_bwd_cases = time_k1b_shapes(gp, k1b_shapes("mt"), args.seed + 22)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("21-22 second order, multitask shapes")
        gp.gather_pool.launches_by_shape.clear()  # from here: K1 of phases 23-24 by shape
        match = twin_zoo(gp, args.seed, card, MATCH, "match_zoo", config=slice_config,
                         expect_tables=MATCH_TABLES)  # phase 23
        clock.lap("23 match zoo")
        match_runs = match_paths(gp, work, args.seed, card)  # phase 24
        clock.lap("24 match paths")
        match_k1_by_shape = dict(gp.gather_pool.launches_by_shape)
        check_match_shapes(gp, args.seed + 25, card)  # phase 25
        match_cases = time_k1_shapes(gp, k1_shapes("match"), args.seed + 25)
        match_bwd_cases = time_k1b_shapes(gp, k1b_shapes("match"), args.seed + 25)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("25 match shapes")
        gp.gather_pool.launches_by_shape.clear()  # from here: K1 of phases 26-27 by shape
        k1b_before = collections.Counter(gp.gather_pool_bwd.launches_by_shape)
        graph = graph_zoo(gp, args.seed, card)  # phase 26
        clock.lap("26 graph zoo")
        graph_runs = graph_paths(gp, work, args.seed, card)  # phase 27
        clock.lap("27 graph paths")
        graph_k1_by_shape = dict(gp.gather_pool.launches_by_shape)
        graph_k1b_by_shape = collections.Counter(gp.gather_pool_bwd.launches_by_shape)
        graph_k1b_by_shape.subtract(k1b_before)
        check_graph_shapes(gp, args.seed + 28, card)  # phase 28
        graph_cases = time_k1_shapes(gp, k1_shapes("graph"), args.seed + 28)
        graph_bwd_cases = time_k1b_shapes(gp, k1b_shapes("graph"), args.seed + 28)
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("28 graph shapes")
        # phases 29-32: the tree family, a2c, the movie demo, their shapes
        slice_cases, slice_bwd_cases, slice_k1, slice_k1b = tree_rl_demo(
            gp, work, args.seed, card, clock)
        # phases 33-36: the online loop, the cube store, their shapes
        online_cases, online_bwd_cases, online_k1, online_k1b = online_phases(
            gp, work, args.seed, card, clock)
        # phases 37-41: the host-tiered table, the resident and native feeds,
        # observability, their shapes
        host_cases, host_bwd_cases, host_k1, host_k1b, host_rest = host_phases(
            gp, work, args.seed, card, clock)
        # phases 42-45: RankModel, feature importance, TIPC, the engine
        api_cases, api_bwd_cases, api_k1, api_k1b, engine, api_deepfm_k1 = (
            api_parallel_phases(gp, work, args.seed, card, clock))
        # phases 46-48: the trainer on a 2x2 mesh of ranks, their shapes
        mesh_cases, mesh_bwd_cases, mesh_k1, mesh_k1b = mesh_phases(
            gp, work, args.seed, card, clock)
        # phases 49-51: geo, FL and the online day across processes, their shapes
        cross_cases, cross_bwd_cases, cross_view_k1, cross_view_k1b, cross_k1, cross_k1b, _ = (
            cross_phases(gp, work, args.seed, card, clock))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for case, batch in zip(cases, BATCHES):
        case["launches"] = launches[batch]
    cases[-1]["launches"] += host_rest["deepfm_k1"]  # phases 38 and 40
    cases[0]["launches"] += api_deepfm_k1 + cross_view_k1  # phases 42-43, 49-50
    # K1b's rows also carry their count by run (DeepFM's runs, the sparse
    # deepfm run) or by row width (the rest), each of which must be above 0
    for case, batch in zip(bwd_cases, BATCHES):
        case["launches_at_width"] = train_runs[batch]["k1b_launches"]
    bf16_bwd_cases[0]["launches_at_width"] = train_runs["bf16"]["k1b_launches"]
    compact_cases[-1]["launches_at_width"] = sparse["runs"]["deepfm"]["k1b_launches"]
    # the bf16 view's lookups: the config_bigdata.yaml runs' steps and evaluations
    big_cases[0]["launches"] = sum(r["k1_launches"] + r["eval"]["k1_launches"]
                                   for r in sparse["runs"].values()) + host_rest["bigdata_k1"]
    if big_cases[0]["launches"] < 1:
        raise AssertionError("the config_bigdata.yaml runs launched no K1")
    # ffm's train() and evaluate(), counted by row width where the kernels launch
    ffm_run = paths["runs"]["ffm"]
    for case in zoo_cases:
        case["launches"] = ffm_run["k1_launches_by_dim"].get(case["dim"], 0)
    for case in zoo_bwd_cases:
        case["launches_at_width"] = ffm_run["k1b_launches_by_dim"].get(case["dim"], 0)
    if not all(case["launches"] > 0 for case in zoo_cases) or not all(
            case["launches_at_width"] > 0 for case in zoo_bwd_cases):
        raise AssertionError(f"ffm's run launched no kernel at a zoo shape: "
                             f"{ffm_run['k1_launches_by_dim']}")
    # the sequence models' phases 13 and 14, counted by row width at the launch
    for cases_at, key, field in ((seq_cases, "k1_by_dim", "launches"),
                                 (seq_bwd_cases, "k1b_by_dim", "launches_at_width")):
        for case in cases_at:
            case[field] = seq[key].get(case["dim"], 0) + seq_runs[key].get(case["dim"], 0)
    if not all(case["launches"] > 0 for case in seq_cases) or not all(
            case["launches_at_width"] > 0 for case in seq_bwd_cases):
        raise AssertionError(f"the sequence models launched no kernel at a shape: "
                             f"{seq['k1_by_dim']} {seq_runs['k1_by_dim']}")
    # the rest of the rank family's phases 16 and 17, counted the same way
    for cases_at, key, field in ((rest_cases, "k1_by_dim", "launches"),
                                 (rest_bwd_cases, "k1b_by_dim", "launches_at_width")):
        for case in cases_at:
            case[field] = rest[key].get(case["dim"], 0) + rest_runs[key].get(case["dim"], 0)
    if not all(case["launches"] > 0 for case in rest_cases) or not all(
            case["launches_at_width"] > 0 for case in rest_bwd_cases):
        raise AssertionError(f"the rank family launched no kernel at a shape: "
                             f"{rest['k1_by_dim']} {rest_runs['k1_by_dim']}")
    # the multitask family's phases 19 and 20, counted the same way
    for cases_at, key, field in ((mt_cases, "k1_by_dim", "launches"),
                                 (mt_bwd_cases, "k1b_by_dim", "launches_at_width")):
        for case in cases_at:
            case[field] = mt[key].get(case["dim"], 0) + mt_runs[key].get(case["dim"], 0)
    if not all(case["launches"] > 0 for case in mt_cases) or not all(
            case["launches_at_width"] > 0 for case in mt_bwd_cases):
        raise AssertionError(f"the multitask family launched no kernel at a shape: "
                             f"{mt['k1_by_dim']} {mt_runs['k1_by_dim']}")
    # phases 23 and 24, counted by shape at the launch: every K1 launch of
    # theirs is at one of MATCH_SHAPES
    match_k1 = match["k1"] + match_runs["k1"]
    for case in match_cases:
        case["launches"] = match_k1_by_shape.get(
            (case["rows"], case["dim"], case["dtype"], case["n"], case["pool"]), 0)
    if (sum(case["launches"] for case in match_cases) != match_k1
            or sum(match_k1_by_shape.values()) != match_k1
            or not all(case["launches"] > 0 for case in match_cases)):
        raise AssertionError(f"phases 23-24 launched K1 {match_k1} times, by shape "
                             f"{match_k1_by_shape}")
    # phases 26 and 27, counted by shape at the launch the same way
    graph_k1 = graph["k1"] + graph_runs["k1"]
    for case in graph_cases:
        case["launches"] = graph_k1_by_shape.get(
            (case["rows"], case["dim"], case["dtype"], case["n"], case["pool"]), 0)
    if (sum(case["launches"] for case in graph_cases) != graph_k1
            or sum(graph_k1_by_shape.values()) != graph_k1
            or not all(case["launches"] > 0 for case in graph_cases)):
        raise AssertionError(f"phases 26-27 launched K1 {graph_k1} times, by shape "
                             f"{graph_k1_by_shape}")
    all_runs = list(train_runs.values()) + list(sparse["runs"].values())
    k1_launches = (sum(launches.values()) + first["k1_launches"]
                   + sparse["first"]["k1_launches"] + sparse["served_launches"]
                   + sum(r["k1_launches"] + r["eval"]["k1_launches"] for r in all_runs)
                   + zoo["k1_launches"] + paths["k1_launches"] + seq["k1"] + seq_runs["k1"]
                   + rest["k1"] + rest_runs["k1"] + mt["k1"] + mt_runs["k1"] + match_k1
                   + graph_k1 + slice_k1 + online_k1 + host_k1 + api_k1)
    k1b_launches = (first["k1b_launches"] + sparse["first"]["k1b_launches"]
                    + sum(r["k1b_launches"] for r in all_runs)
                    + zoo["k1b_launches"] + paths["k1b_launches"] + seq["k1b"]
                    + seq_runs["k1b"] + rest["k1b"] + rest_runs["k1b"] + mt["k1b"]
                    + mt_runs["k1b"] + match["k1b"] + match_runs["k1b"] + graph["k1b"]
                    + graph_runs["k1b"] + slice_k1b + online_k1b + host_k1b + api_k1b)
    if k1_launches < 1 or k1b_launches < 1:
        raise AssertionError("the main path launched a kernel no time")
    # K1b's launches per timed shape, from the whole run: those of the shape's
    # own (rows, D, dtable dtype, N); a compact buffer's rows follow each
    # batch's unique ids, so the compact rows take every key of their (D,
    # dtable dtype, N) that no dense shape names
    by_shape = gp.gather_pool_bwd.launches_by_shape
    if sum(by_shape.values()) != k1b_launches:
        raise AssertionError(f"K1b launches by shape sum to {sum(by_shape.values())}, "
                             f"the run counted {k1b_launches}")
    emit({"k1b_launches_by_shape": sorted([*k, v] for k, v in by_shape.items()),
          "card": card})
    bwd_all = (bwd_cases + bf16_bwd_cases + zoo_bwd_cases + compact_cases + seq_bwd_cases
               + rest_bwd_cases + mt_bwd_cases + match_bwd_cases + graph_bwd_cases
               + slice_bwd_cases + online_bwd_cases + host_bwd_cases + api_bwd_cases)
    dense = {(c["rows"], c["dim"], c["dtype"], c["n"]) for c in bwd_all
             if c["ids"] != "compact"}
    # the host table's compact buffer shares (D, dtype, N) with the 10^8
    # table's: phase 41 counted its launches, which the latter gives up
    host_compact = host_bwd_cases[0]["launches"]
    for case in bwd_all:
        key = (case["rows"], case["dim"], case["dtype"], case["n"])
        case["launches"] = (by_shape.get(key, 0) if case["ids"] != "compact" else
                            sum(v for k, v in by_shape.items()
                                if k[1:] == key[1:] and k not in dense))
    host_bwd_cases[0]["launches"] = host_compact
    compact_cases[-1]["launches"] -= host_compact
    # the engine's rank ran in a process of its own (phase 45), and the mesh's
    # ranks in theirs (phases 46-47), which counted their launches: their rows
    # join after the attribution by this process's keys
    bwd_all.append(engine["k1b"])
    bwd_all.extend(mesh_bwd_cases + cross_bwd_cases)
    bwd_cases[0]["launches"] += cross_view_k1b  # phases 49-50's ranks at DeepFM's B=512 view
    k1_launches += engine["k1_launches"] + mesh_k1 + cross_k1
    k1b_launches += engine["k1b_launches"] + mesh_k1b + cross_k1b
    for case in bwd_all:
        # card time lost to the floor a run: launches × (ms − max(bound, floor))
        case["lost_ms"] = case["launches"] * max(
            0.0, case["ms"] - max(case["bound_ms"], floor_ms))
    match_k1b = match["k1b"] + match_runs["k1b"]
    if (sum(case["launches"] for case in match_bwd_cases) != match_k1b
            or not all(case["launches"] > 0 for case in match_bwd_cases)):
        raise AssertionError(f"phases 23-24 launched K1b {match_k1b} times, by shape "
                             f"{[(c['name'], c['launches']) for c in match_bwd_cases]}")
    graph_k1b = graph["k1b"] + graph_runs["k1b"]
    graph_bwd_keys = {(c["rows"], c["dim"], c["dtype"], c["n"]) for c in graph_bwd_cases}
    if (sum(case["launches"] for case in graph_bwd_cases) < graph_k1b
            or sum(graph_k1b_by_shape.values()) != graph_k1b
            or set(+graph_k1b_by_shape) - graph_bwd_keys
            or not all(case["launches"] > 0 for case in graph_bwd_cases)):
        raise AssertionError(f"phases 26-27 launched K1b {graph_k1b} times, by shape "
                             f"{dict(+graph_k1b_by_shape)}")
    emit(clock.line(card))
    kernels = []
    for name, source, replaces, count, err, timed, top in (
        ("gather_pool", "paddlerec_tpu_torch/csrc/gather_pool.cu",
         "paddlerec_tpu/ops/pallas_embedding.py:37", k1_launches,
         max(main_err, sparse["lookup"]["k1_err"]),
         cases + zoo_cases + big_cases + seq_cases + rest_cases + mt_cases + match_cases
         + graph_cases + slice_cases + online_cases + host_cases + api_cases
         + [engine["k1"]] + mesh_cases + cross_cases,
         cases[-1]),
        # the JAX package has no kernel for the gradient: K1b takes the
        # place of the XLA scatter-add of _packed_lookup_bwd
        ("gather_pool_bwd", "paddlerec_tpu_torch/csrc/gather_pool_bwd.cu",
         "paddlerec_tpu/ops/packed_embedding.py:94", k1b_launches,
         max(bwd_err, sparse["lookup"]["k1b_err"]),
         bwd_all, compact_cases[-1]),
    ):
        # the headline numbers (top) are those of the training batch, 8192, at
        # DeepFM's shape (K1b: at the sparse step's compact shape,
        # config_bigdata.yaml's); the zoo's and the sequence models' shapes
        # stand among the cases
        set_share(timed, floor_ms)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "launch_floor_ms": floor_ms, "share": top["share"],
            "card": card, "cases": timed,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
