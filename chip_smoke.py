"""Chip smoke test of the PyTorch/CUDA port (`shifu_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is then non-zero and no
result line is printed):

1. the card's name, count and power limit, whether `import fsspec`
   succeeds there, and whether `import pyarrow` and `import tensorflow`
   do (asked in a child process); build every kernel from
   `shifu_tpu_torch/csrc/` (one `nvcc` per source, all at once), with
   ptxas's registers, shared memory and spills per kernel;
2. K1 `fused_score` against its plain PyTorch version at 512×600→512, at
   an eval-sized 65,536×600→512, at the odd width 37×37→16 and at H = 1
   (1×20→1, 512×20→1), with NaNs, outliers and a tiny-std column
   (rtol 1e-5 / atol 1e-5), two launches bit-identical;
3. K2 `fused_trees` against its plain version at R = 512 (one warp per
   row) and R = 1,048,576 (one thread per row) on the HIGGS GBT shape
   (28 columns, 20 trees, depth 6, 64 bins, log loss) with NaN and ±inf
   values: landing leaves exact, scores within 1e-6;
4. the main path: model sets written with the port's `save_model` from a
   seed (NN 600→512→256→1 served with `norm`; GBT + RF of the HIGGS
   shape), two `ScorerService`s on the card behind `HttpFrontEnd`
   (each (model, bucket) a captured CUDA graph), requests of
   1/4/16/64/512 rows in process and over `POST /score`, every answer
   held against the same service on the CPU; the kernels' launch
   counters (a graph replay adds its kernels) are zeroed just before
   and must have risen;
5. per kernel, CUDA-event times of the wrapper call, its plain version
   and (K1) one f32 `torch.matmul` over the z-scored input, the kernel's
   own device time from `torch.profiler`, and the bound (K1: 3xTF32 on
   the tensor cores, and the f32 bound beside it), K1 at N = 1, 8, 64,
   512, 65,536 (and at 512 under other plans than `_k1_plan`'s, the
   evidence for its block target) and K2 at R = 1, 64, 512, 1,048,576;
   plus request p50/p95/p99 and the mean per-stage split of both
   services over a closed loop of 1,000 requests per size, and the
   device's idle share over a profiled window of 200 more;
6. K3 `level_hist` (on the builders' uint8 bins and on int32 bins) and
   K4 `level_hist_fused` against their plain versions at R = 2,000,000,
   C = 28, B = 64 for S = 1 and 32, with dump-slot rows and NaN/±inf
   values: integer grads exact, real ones within 1e-5·Σ|grad| per
   slot; K4 equal to K3 over the same bins on integer grads; two
   launches each of K3 (uint8, int32) and K4 at S = 32 on real-valued
   grads bit-identical;
7. K5 `best_splits` at N = 1 ((C,) mask), 32 (the GBT leaf level: one
   (1, C) mask for every node; and a mask a node) and 640 (a 20-tree
   forest level, (T, C) masks), with a tie planted across two
   warps and an all-masked node: on integer-valued histograms against
   its plain version (C = 28, B = 64), on real-valued ones against
   `k5_sequential`, the sequential-f32 reference (C = 28 and 300, B =
   64 and 256); every output bit for bit;
8. the training main path: a raw pipe-delimited table of 28 numeric
   columns and 262,144 rows from a seed, turned into `ColumnConfig.json`
   and `tmp/CleanedData` by the port's own `init → stats → norm` on the
   card, copied into one model set a configuration, and trained by
   `python -m shifu_tpu_torch --dir <set> train` on the card and with
   `--device cpu` (RF 10 trees and one-round squared-loss GBT
   bit-exact; 10-tree log-loss GBT, also through K4 with
   SHIFU_TPU_HIST_FUSED=1, within 1e-4 relative train log-loss and 1e-3
   AUC); each card run reports its kernels' launches, which must be
   non-zero; the port's `serve` then scores the card-trained GBT;
9. training times at the HIGGS widths (28 columns, depth 6, 64 bins,
   log loss, lr 0.2): per kernel at the main path's shapes (events,
   profiler, plain, bound; K3 on uint8 and int32 bins with both bounds,
   and `torch.bincount`); K3 over one tree's levels (S = 1 with every
   row live, then S = 1 … 32 with the left children live), whose sum
   stands beside the profiled tree's K3 time; K3 on skewed bins (90 %
   in one bin) and under forced plans (histogram replicas, cluster
   sizes); K5 at N = 1, 32 ((1, C) and (32, C) masks), 320 and 640
   beside the launch floor (a one-element `add_`) and with 8, 16 and 32
   warps a block, its bound counting only the columns it reads (column
   0 and those switched on), and under RF's SQRT feature subsets;
   2,000,000 rows ×
   10 trees end to end with one profiled tree split by kernel and the
   device's idle share, per-level host and device times, and one
   level's split step counted in launches (the search, then the fold);
   11,000,000 rows × 20 trees when the projected time fits half the
   limit;
10. `init → stats → norm` (maxNumBin 63, EqualPositive; ZSCALE, then
   WOE) as `python -m shifu_tpu_torch` processes on the card and on a
   copy with `--device cpu`, over a raw table of the HIGGS widths plus 2
   categorical, a weight and a meta column (262,144 rows, 2 % missing
   tokens): ColumnConfig.json equal but for the f32 sums (mean/std and
   weighted bin sums within rtol 1e-5, skewness/kurtosis atol 1e-4),
   CleanedData and the WOE block equal, the ZSCALE block within 1e-5;
   each step's JSON line (device, rows, read and total seconds); the
   CPU twin's steps run beside the card's; the phase runs in a process
   of its own (`--p10`) beside phases 11-13 and prints when collected;
11. the NN of phase 4's shape (600 → 512 → 256 → 1, weights from a
   seed) over a raw table of 600 numeric columns and 16,384 rows (2 %
   missing tokens) made into ColumnConfig.json by the port's `init` and
   `stats` on the card: `eval` over the ZSCALE set (through K1) on the
   card and with `--device cpu` (EvalScore.csv, the AUCs and the
   buckets within 1e-5, or one row's share at a tie edge; `fused_score`
   launched), `posttrain` timed on the card at full size and held
   against the CPU on the first 4,096 rows (importance within 1e-4
   relative, binAvgScore 1e-5);
12. the NN/LR trainer: phase 11's set gets `norm` ZSCALE on the card at
   full size and on its first 8,192 rows (the CPU twins' cut); on those
   rows `train` on the card and with `--device cpu` from the same
   matrix: the wide NN (600 → 512 → 256 → 1, relu, 2 Poisson bags, 20
   epochs) under B and M (per-epoch train/val errors within 1e-5 of the
   curve's largest value, best epochs equal, every saved array within
   1e-4 of its largest entry), LR 600 → 1 under R and the NN under ADAM
   (each bag's best val error within 1e-3 relative: sign-driven rules
   part on near-zero gradients); at 16,384 rows the card trains the NN
   (ADAM) and LR (R), and `eval` of each runs on the card (through K1,
   `fused_score` launched) and on a CPU twin with phase 11's gates, the
   card `train`'s steps.jsonl record carrying a `roofline` block
   (`profiling.ROOFLINE_FIELDS`, 0 < `mxu_util` <= 1); a
   3-class table of the HIGGS widths (16,384 rows, a 16,384-row holdout,
   `init → stats → norm` on the card): NATIVE and ONEVSALL NNs (28 → 64
   → 3, momentum) trained and `eval -run` on the card and the CPU (class
   scores within 1e-4, the C×C matrix within one row's share); then
   `nn_sync_gate`: five epochs of the trainer's loop at the wide and the
   flagship shapes (below) under `torch.cuda.set_sync_debug_mode
   ("error")` (their timings are `--nn-train-walls`' alone);
13. varselect, the stats flags, export and encode, card against a CPU
   twin that runs the same verbs in two processes (`--cpu-verbs`)
   beside the card's: phase 10's table with a `month` cohort and a
   `day` date column (262,144 rows): `init` and `stats` with DateStats
   (within 1e-5 of each metric's scale, DateStats.csv also within one
   unit of its sixth printed digit), then from one ColumnConfig.json
   `stats -correlation` (Pearson within 1e-5), `-psi` (each psi within
   1e-6), `-rebin -n 5` (ColumnConfig.json equal), `export -t
   columnstats/woemapping/woe/correlation` (byte-equal; correlation
   within 1e-5), varselect KS, IV, MIX, PARETO (filterNum 15), `-f`,
   `-list`, `-reset` and FI (RF 10 trees, depth 6, 64 bins; selections
   equal, K3 and K5 counted between marker kernels), V (20 nets × 5
   generations from the same initial weights, on the table's first
   32,768 rows: each generation's best validation error within 1e-4
   relative, selection equal but for a near-tie swap it reports; then
   on the card at full size); SE, ST and `-r 1` on phase 12's 8,192-row
   cut of the 600-column table (se.0 within 1e-4 of the largest delta,
   selection equal but at the cut's tie), then SE on the card at
   16,384 rows; `export -t pmml` of phase 8's card-trained RF and GBT
   and phase 12's LR, `-t baggingpmml` of its 2-bag wide NN: byte-equal
   to the CPU twin's, conformant, and `evaluate_pmml` over 4,096 raw
   holdout rows within 1e-6 (trees, through K2) or 1e-5 (NN/LR, through
   K1) of `Scorer.score` on the card; `export -t bagging` (zip members
   equal) and a `convert` round trip; `encode` of phase 8's GBT
   (part-00000 byte-equal); `new`, `save`, `switch` and `show` on a
   copy of phase 8's GBT set (the restored files equal the saved ones);
14. WDL, MTL and `train#trainOnDisk`, card against a CPU twin: (a) WDL
   at `bench.py:96-108`'s widths (13 dense, 26 categorical with ids
   Zipf over 10,000 values, embed 16, deep 256 → 128) and (b) MTL at
   `bench.py:110-119`'s (64 features, tasks `t0|t1|t2|t3`, tasks 1-3
   untagged on 10 % of the rows, 128 → 64), each a 32,768-row raw table
   through the port's `init → stats → norm` on the card, `train` (ADAM,
   2 bags) on the card and the CPU from the same matrix (each bag's best
   validation error within 1e-4 relative), `eval` and `posttrain` of the
   card-trained models on both (scores within 1e-5; importance 1e-4,
   binAvgScore 1e-5 relative) and `serve` over `POST /score` with
   `dense` and `index` (within 1e-5); (c) `norm` with trainOnDisk on the
   card and the CPU for a 65,536-row HIGGS table and copies of (a) and
   (b) (every `.npy` file equal to the bit), then streaming NN, WDL and
   MTL (best validation errors within 1e-4), log-loss GBT on both
   row-state tiers (train log-loss within 1e-4, AUC 1e-3) and RF
   (files equal to the bit) over 5-6 chunks; (d) the device-tier GBT
   trained twice on the card, and the same set trained resident
   (`build_gbt`) twice: each pair's model files equal to the byte in
   every member (K3/K4 add in fixed point). Then `--p14-launches` in
   a process of its own: the streaming builders' K3/K5 launches between
   marker kernels must equal (max_depth + 1) a chunk and max_depth a
   tree on both tiers (and 7 / 6 with one chunk); the timings of
   WDL/MTL at 500,000 rows and `build_gbt_streaming` at 2,000,000 × 28
   are `--p14-walls`' alone;
15. past the trigger: phase 10's table with phase 13's cohorts (131,072
   rows) under SHIFU_TPU_{STATS,NORM,EVAL,ANALYSIS}_CHUNK_ROWS = 32,768
   (8 chunks), every step a process on the card beside its `--device
   cpu` twin: the streaming `stats` (ColumnConfig.json equal but for the
   float64 sums within 1e-9), `stats -correlation` (1e-5) and `-psi`
   (1e-6), the streaming `norm` with trainOnDisk (every `.npy` file
   equal to the bit), `varsel` KS and FI (selections equal, K3 and K5
   counted between marker kernels), GBT and RF trained by the streaming
   builders on the card, and the streaming `eval -run` of the GBT + RF
   set (K2 launched, scores and metrics within 1e-6), of an NN over
   ZSCALE (K1 launched, scores within 1e-5, AUCs within 1e-6 plus the
   share of pairs the scores' differences can reorder, `perf_allowance`)
   and of a 3-class
   NATIVE NN (32,768 rows, class scores within 1e-5, the C×C matrix
   within one row's share);
16. the serving plane (`phase_serving_plane`): (a) phase 4's services
   with CUDA graphs beside eager and CPU twins — one capture per (model,
   bucket), every bucket bit-equal to the eager card path and within
   1e-5 (NN) / 1e-6 (trees) of the CPU, 512 mixed-size requests with no
   capture after warm-up, under SHIFU_TPU_TRACE=1: each request's
   `serve.request` span with five children equal to its `timing`
   splits within 1 µs; their K1/K2 launches counted through the
   replays and one replay's kernels equal to the profiler's between
   marker kernels; (b) `swap_params` ten times between two NNs of phase
   4's shape trained by the port on two seeds while a client submits
   without pause (every answer wholly old or new, none failed, no
   capture), and an other-shaped set refused; (c) a registry (two
   versions of one NN, the trees, a low-priority NN) served by a fleet
   on the card under SHIFU_TPU_FLEET_HBM_MB that holds an NN and the
   trees: routes bit-equal to standalone services, evictions and
   re-warms counted, the memory an eviction frees printed, low priority
   shed under a tiny SLO while high flows, `rollback` swapped in and
   `gc`; (d) with SHIFU_TPU_METRICS=1 a 20,000-row GBT set through
   `init → eval` on the card (`eval.*` points), a service's flusher
   (`serve.*` points), then a shifted dataPath: `watch --monitor-only
   --iterations 3` on the card breaches `drift.psi_max` with drift points
   equal to a `--device cpu` twin's, `health` exits 1 and `/healthz`
   reports the breach;
17. the closed loop (`phase_closed_loop`) over phase 16's sets, with
   SHIFU_TPU_METRICS=1: (a) (d)'s shifted rows appended to a
   two-partition row log of 4,096-row segments, a fault between the
   renames of a seal and the rerun re-sealing the same sequence with no
   `.tmp.*` left, `ingest ls` as a process; (b) in a process of its own,
   (d)'s GBT set published and served from a fleet under a client that
   never pauses, one `watch --ingest` tick breaching on drift and its
   refresh controller retraining warm on the card (K3/K5 counted between
   marker kernels, a graph capture started mid-retrain equal to eager),
   guarding (K2), publishing and swapping by re-warm: no request failed,
   the manifest's window re-read byte for byte, both offsets committed,
   the guardrail's AUCs and decision those of a `--device cpu` twin
   within 1e-6; (c) (b)'s first NN refreshed on 8,192 new rows, two
   epochs, swapped in place with no capture, every answer wholly old or
   new, the AUCs within 1e-5 of a CPU twin's; (d) (b)'s two NNs through
   a canary (shadow 0.5, canary 0.2, 32 requests an arm) under mixed
   traffic: the arm captured at `start_arms` only, HEAD the challenger,
   answers bit-equal to a standalone challenger service; a slow
   challenger rolled back mid-canary; a canary process SIGKILLed in its
   shadow phase rolled back by `watch`'s recovery, CANARY.json cleared;
   (e) `watch --ingest --registry --iterations 3` as processes on the
   card and with `--device cpu`: the same decision, AUCs within 1e-6,
   and `health`'s refresh and canary lines;
18. checkpoints and resume (`phase_checkpoint_resume`) in phase 16's
   work directory: (a) an 8,192 × 600 NN set (600 → 512 → 256 → 1,
   ADAM, dropout 0.1, 12 epochs, CheckpointInterval 4) through `init →
   stats → norm` on the card; `train` as a process SIGKILLed right after
   its 2nd checkpoint (``ckpt.saved:kill:2``, the background writer):
   `ckpt` reports step 8 and the one-card sidecar, no `.tmp` left; the
   resume with SHIFU_TPU_RESUME=1 in process logs epoch 8 and ends on an
   uninterrupted card run's model, best validation error and last four
   epochs' curve, bit for bit, `eval` of both through K1 within 1e-6 of
   AUC; one checkpoint of the full-width carry timed; (b) a preemption
   after the first save: supervised (SHIFU_TPU_MAX_RESTARTS=2) one
   `restart` record in steps.jsonl and the same model, unsupervised rc
   75 and a resume to the same model; (c) the streaming NN over the
   `.npy` layout (ChunkRows 2,048, CheckpointInterval 1) preempted at
   its 2nd save (rc 75), resumed to an uninterrupted streaming run's
   model, its checkpoints removed once the model is saved; (d) in a
   process of its own, phase 16 (d)'s GBT set: `stats → norm → train →
   eval` write their manifests, a rerun with SHIFU_TPU_RESUME=1 skips
   every step with no K2/K3/K5 between marker kernels, a newline
   appended to ModelConfig.json re-runs `train` and `eval` (K3 +25, K5
   +20 between markers, K2 again) to the same EvalScore.csv, and `norm`
   failing at its first atomic commit leaves no manifest and meta.json
   byte for byte;
19. the pipeline DAG (`shifu_tpu_torch/pipeline/`) in a process of its
   own (`--p19-dag`), started with phase 15 and collected after phase
   18, over a 65,536-row table of phase 10's layout (a 16,384-row eval
   file as eval sets Eval1 and Eval2; GBT 20 trees, depth 6, 64 bins,
   log loss; the NN 64 hidden units, `bench.py:76-78`): (a) `run_dag`
   of `pipeline_nodes` with GBT + RF (the RF a `prepare_variant` clone)
   and posttrain under the default admission, traced
   (SHIFU_TPU_TRACE=1) inside `step_metrics` as a verb runs, in a process
   of its own (`--p19-traced-leg`): one merged trace with one `run.step`
   of that process, a `dag.node` span a node (its parent, state done,
   `dag.queue`/`dag.run` children), one `run.step` of each node process
   in the merge, one steps.jsonl record a node verb (rc 0; `backend`
   cuda and `deviceCount` 1 but for `init`; train.GBT's
   `peakBytesInUse` > 0) and the coordinator's with its `dag` block; every node done, the two
   trainers overlapping (timeshared: max_concurrent >= 2; several
   cards: a lease each), ColumnConfig.json, the normalized and cleaned
   data, both models, both EvalPerformance.json and
   featureimportance.csv equal to the bit to the same steps walked in
   this process (`cli.main`) on a copy; then, with SHIFU_TPU_RESUME=1
   and eval.Eval1's manifest removed, the nodes end in the states their
   manifests predict (posttrain rewrote ColumnConfig.json after stats,
   norm and train wrote theirs: C-ref-4), eval.Eval1 among those run,
   no node run that C-ref-4 leaves valid (init, train.RF and posttrain
   cached), every output unchanged; then `python -m shifu_tpu_torch
   --profile --dir <copy> train` under SHIFU_TPU_TRACE=1 in a fresh
   process: `trace ls` pairs its span trace and its profile, the
   profile's K3/K5 kernels count what its line reports, its record has
   `trace` and `tree_build_dispatches`, `top` shows its `train` row
   with rc 0, and the step's card idle share (one minus the union of
   kernel intervals over `run.step`) is printed; (b) `stats -base-only`, `-seg 1`,
   `-seg 2`, `-seg-merge` in this process: ColumnConfig.json
   byte-equal to an inline `stats` on the card and to a `--device cpu`
   inline twin; (c) `combo -new NN,GBT,LR`, `-init`, `-run` (the
   sub-models overlap), `-run -resume` (both cached, the same assemble
   model to the bit), `-eval` (the assemble's card scores within 1e-5
   of the CPU's, then the AUC within 1e-6 plus `auc_allowance` of
   `combo.evaluate(device="cpu")` over the same files); (d) `test -n 200`: rc 0, the five nodes of the JAX
   package's DAG, each done. The child processes' launches come from
   their step lines (`tmp/dag_logs/*.log`);
20. parquet and `scheme://` model sets and the `tf` kind
   (`phase_remote_parquet_finish`) in a process of its own (`--p20`),
   started with phase 14 and collected after phase 19: (a) phase 8's
   raw table (28 numeric columns and a label, 262,144 rows, a
   65,536-row holdout as eval set Eval1) as a delimited part file and
   as 4 parquet part files of float32 columns under a `file://` URL
   (written through `data/parquet.write_part`): `init → stats → norm →
   train` (phase 8's 10-tree log-loss GBT) and `eval` through `cli.main`
   on the card over both, ColumnConfig.json, the cleaned and normalized
   data, the GBT file, EvalScore.csv and EvalPerformance.json
   byte-equal, K2, K3 and K5 launched by each; (b) the same text behind
   `memory://` (dataPath, headerPath, the eval set): every output equal
   to (a)'s text route to the bit; a row log on a `file://` root seals
   one segment, read back and committed, and an abort marker on a
   `file://` scope is published, read and cleared; (c) in a process of
   its own (`--p20-tf`; TensorFlow never shares one with another
   phase): phase 11's wide NN (600 → 512 → 256 → 1) over a 4,096-row
   ZSCALE set, `init` and `stats` on the card; with tensorflow, `export
   -t tf` and `eval` of the spec beside its SavedModel (the NN column
   through K1, the SavedModel's on the host, within 1e-5); without it,
   `eval` through K1 and the gating errors of `export -t tf` and of
   scoring a SavedModel. Its K1, K2, K3 and K5 launches must be
   non-zero.

Phase 8 then registers a holdout table (262,144 rows, another seed) as
eval set `holdout` of the card-trained RF and log-loss GBT sets and runs
`posttrain` and `eval` as processes on the card and, beside it, on a
`--device cpu` copy (the same model files): featureimportance.csv
equal, binAvgScore within 1e-6 relative, EvalScore.csv, the AUCs, every
bucket field and EvalConfusionMatrix.csv within 1e-6 (or one row's
share where a tie group straddles a bucket edge), `fused_trees`
launched in each card eval; on the GBT set also `eval -score`,
`-confmat`, `-perf`, `-norm` (EvalNorm.csv within 1e-6) and `-audit
-n 100` (line for line, scores within 1e-6). The K1/K2 launch counts
of the kernels line add these card runs, phases 11's and 12's card
evals and phase 13's PMML check to phase 4's, and the K3/K5 counts
phase 13's FI run, phase 14's streaming tree trainings and phase 15's
FI, GBT and RF runs to phase 8's (and phase 15's evals to K1/K2's);
phase 16 adds its mixed traffic's K1/K2 replays and its health set's
`train` and `eval`, phase 17 its refreshes' K1/K2/K3/K5 and (b)'s
serving, phase 18 its evals' K1, (d)'s K2 and its trainings' K3/K5,
phase 19 its DAG's, combo's and its own K2/K3/K5 (its path launches no
K1: combo scores its NN sub-model through `ModelRunner`'s plain
forward, as the JAX package does), phase 20 its three routes' K2/K3/K5
and (c)'s K1.

The last lines are the per-kernel launch line, the kernel JSON line,
the card's name and power limit, and the result object.

`python3 chip_smoke.py --train-walls` times only the 2M × 10 builds (and
the split step's host time a level), `--serve-walls` only both services'
closed loop at each bucket (1, 8, 64, 512 rows), `--k5-timing` only
phase 9's K5 rows, `--pipeline-walls` only `init`/`stats`/`norm` on the
card at 2,000,000 rows of phase 10's table (read and compute seconds a
step), `--eval-walls` only `eval` on the card over a 2,000,000-row eval
file of phase 8's table with a GBT + RF ensemble (read, score and total
seconds), `--nn-train-walls` only phase 12's timing: `train_nn` on the
card at the wide shape (300,000 × 600 → 512 → 256, 2 and 102 epochs) and
the flagship (2,000,000 × 32 → 64, 2 and 32 epochs), `bench.py`'s
two-length method (row·epochs/s, ms an epoch, the f32 peak share by
`bench.py`'s FLOPs a row), launches an epoch between marker kernels, the
idle share over five profiled epochs, and five epochs under
`torch.cuda.set_sync_debug_mode("error")`; `--varselect-walls` only
phase 13's card steps, each a process with the host to itself, twice:
`stats -correlation` at 262,144 × 30, `varsel` FI, `encode` of its RF,
SE at 65,536 × 600 and `export -t baggingpmml` of a 2-bag wide NN;
`--closed-loop` only phase 17 (after the build and the phase 16
steps it reuses); `--remote-parquet` only phase 20 (after the build); `--checkpoint-resume` only phase 18 (after the build
and phase 16 (d)'s GBT set); `--dag` only phase 19 (after the build);
`--p14-walls` only phase 14's launch counts and
timings (it needs the WDL/MTL and streaming modules; the main run asks
only for the counts, `--p14-launches`); `--stream-walls` only `stats`, `norm`
and `eval` (a 10-tree GBT) on the card at 2,000,000 rows of phase 10's
table, resident and then streaming (ChunkRows 262,144), each step's
read, compute and write seconds (it needs the streaming modules);
`--k3-timing` only K3 (uint8, int32) and K4 at 2,000,000 × 28 × 64, S =
1 and 32, on real-valued grads; `--serving-plane` only phase 16 (after
the build); `--serve-walls` also sets each service's graphs against its
eager twin at each bucket, in turns (`--serve-walls 1,512` at those
buckets only); `--serve-walls-pairs PARENT N` runs `--serve-walls 1,512`
in N process pairs, the tree unpacked at PARENT (this script copied
into it) against this one, in turns, tracer off, and prints each
p50/p99's min, median and max per tree. The others call only functions that
older trees of the port have too, so the script copied into the root of
an older tree times that tree: run the two in turns on one card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

MEM_BW = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12    # H100 SXM dense TF32 tensor-core FLOP/s

NN_IN, NN_HIDDEN = 600, (512, 256)        # bench.py:90-92
GBT_COLS, GBT_TREES, GBT_DEPTH, GBT_BINS = 28, 20, 6, 64  # bench.py:171-174
CUTOFF = 4.0
SIZES = (1, 4, 16, 64, 512)
STREAM = 1000          # closed-loop requests per size: ≥ 10 beyond p99
IDLE_WINDOW = 200      # profiled closed-loop requests per size


# ---------------------------------------------------------------------------
# Inputs and models made from a seed
# ---------------------------------------------------------------------------

def norm_params(rng, c=NN_IN):
    mean = rng.normal(0.5, 1.0, c).astype(np.float32)
    std = rng.uniform(0.5, 2.0, c).astype(np.float32)
    std[7] = 1e-7                            # tiny std → z exactly 0
    return mean, std


def raw_rows(rng, n, mean, std):
    """Raw NN input rows around the norm params, with NaN cells, a NaN
    row and outliers beyond the clamp."""
    x = (mean + std * rng.normal(0, 1.5, (n, len(mean)))).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[0, :10] = 1e6
    if n > 1:
        x[1] = np.nan
    return x


def nn_params(rng):
    """Xavier-uniform weights, small random biases."""
    dims = [NN_IN, *NN_HIDDEN, 1]
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        out.append({"w": rng.uniform(-lim, lim, (fan_in, fan_out))
                    .astype(np.float32),
                    "b": rng.normal(0, 0.01, fan_out).astype(np.float32)})
    return out


def tree_rows(rng, n, c=GBT_COLS):
    """HIGGS-like raw numeric rows with NaN and ±inf values."""
    x = rng.normal(0, 1, (n, c)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[rng.random(x.shape) < 0.002] = np.inf
    x[rng.random(x.shape) < 0.002] = -np.inf
    return x


def tree_model(rng, kind, loss, t=GBT_TREES):
    """`t` random perfect trees of depth 6 over 28 columns with quantile
    cuts (62 per column; 64 bins incl. the missing slot), a few
    subtrees cut short by early leaves."""
    sample = rng.normal(0, 1, (20000, GBT_COLS)).astype(np.float32)
    qs = np.linspace(0, 1, GBT_BINS - 1)[1:-1]          # 62 cuts
    num_cuts = np.quantile(sample, qs, axis=0).astype(np.float32)
    n_nodes = 2 ** (GBT_DEPTH + 1) - 1
    n_internal = 2 ** GBT_DEPTH - 1
    feature = rng.integers(0, GBT_COLS, (t, n_nodes)).astype(np.int32)
    bins = rng.integers(0, GBT_BINS - 1, (t, n_nodes)).astype(np.int32)
    is_leaf = np.zeros((t, n_nodes), bool)
    is_leaf[:, n_internal:] = True
    is_leaf[:, 3:n_internal] |= rng.random((t, n_internal - 3)) < 0.05
    feature[is_leaf] = -1
    trees = {"feature": feature, "bin": bins,
             "default_left": rng.integers(0, 2, (t, n_nodes))
             .astype(np.int32),
             "is_leaf": is_leaf,
             "gain": np.zeros((t, n_nodes), np.float32),
             "leaf_value": rng.normal(0, 0.5, (t, n_nodes))
             .astype(np.float32)}
    meta = {"kind": kind,
            "treeConfig": {"max_depth": GBT_DEPTH, "n_bins": GBT_BINS,
                           "learning_rate": 0.1, "loss": loss}}
    tables = {"num_cuts": num_cuts,
              "cat_map": np.zeros((0, 1), np.int32)}
    return meta, {"trees": trees, "tables": tables}


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters, warmup=3):
    """Mean device time of `fn` over `iters` back-to-back calls, by CUDA
    events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters, kernel):
    """Mean device time of the CUDA kernel named `kernel` over `iters`
    calls of `fn`, from `torch.profiler`; None when the profiler records
    no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            us = getattr(ev, "self_device_time_total", 0) or \
                getattr(ev, "device_time_total", 0)
            return us / ev.count / 1e3 if us else None
    return None


def device_busy(fn):
    """Run `fn` under `torch.profiler` → (wall ms, device ms): the wall
    time of the window and the device time of every kernel and copy the
    profiler saw in it, from whichever thread launched them (the
    service's batcher thread)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = sum(ev.self_device_time_total for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    return wall_ms, dev_us / 1e3


def bound_ms(n_bytes, n_ops):
    t_mem = n_bytes / MEM_BW * 1e3
    t_ops = n_ops / F32_PEAK * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def k1_cost(n, c, h):
    """Bytes: values, mean, std, w, b read once, out written once.
    Operations: 2·N·C·H for the product, 5·N·C for the normalize."""
    return 4 * (n * c + 2 * c + c * h + h + n * h), 2 * n * c * h + 5 * n * c


def k1_tf32_bound_ms(n, c, h):
    """The least time of an f32-accurate product on the card: the same
    bytes as `k1_cost`, against 3·2·N·C·H TF32 operations (3xTF32) at
    the tensor cores' peak and the normalize's 5·N·C at the f32 peak,
    whichever is longest."""
    n_bytes, _ = k1_cost(n, c, h)
    t_mem = n_bytes / MEM_BW * 1e3
    t_tc = 3 * 2 * n * c * h / TF32_PEAK * 1e3
    t_alu = 5 * n * c / F32_PEAK * 1e3
    t = max(t_mem, t_tc, t_alu)
    return t, ("bytes" if t == t_mem else "operations")


def k2_cost(c, r, k, s, n_trees, leaves):
    """Bytes: valuesT, cuts, the five node rows the walk reads (feature,
    bin, default_left, stop, leaf; rows 5-7 of the (8, S) block are
    padding nothing reads) once each, scores written once. Operations
    (this run's data): ⌈log2(K+1)⌉ compares per cell for the bins, the
    least that finds Σ(v ≥ cut) over ascending cuts (the kernel's
    binary search); 3 per node step each row took (compare, select,
    index), counted from the landing node depths; one add per tree and
    row."""
    import torch
    steps = int(torch.floor(torch.log2(leaves.double() + 1)).sum())
    return 4 * (c * r + c * k + 5 * s + r), \
        r * c * math.ceil(math.log2(k + 1)) + 3 * steps + r * n_trees


def check_close(name, got, want, rtol, atol):
    import torch
    err = float((got - want).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, msg=lambda m: f"{name}: {m}")
    print(f"  {name}: max |err| {err:.3g} (rtol {rtol}, atol {atol}) ok")
    return err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    try:
        import fsspec
        print(f"fsspec: import fsspec succeeds ({fsspec.__version__})")
    except ImportError as e:
        print(f"fsspec: import fsspec fails ({e})")
    return name, smi


def phase_build():
    from shifu_tpu_torch import _build
    t0 = time.monotonic()
    logs = _build.build_all(extra_flags=["-Xptxas", "-v"])
    print(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                where = f"{name} {fn}" if name in (
                    "fused_score", "fused_trees", "level_hist") else name
                print(f"  ptxas {where}: {line.strip().split(':', 1)[-1]}")


def k1_inputs(seed, n, device, c=NN_IN, h=NN_HIDDEN[0]):
    """Raw rows, norm params and a first layer (C, H) drawn as
    `nn_params` draws it (the NN's first layer at the default width)."""
    import torch
    rng = np.random.default_rng(seed)
    mean, std = norm_params(rng, c)
    x = raw_rows(rng, n, mean, std)
    lim = math.sqrt(6.0 / (c + h))
    w = rng.uniform(-lim, lim, (c, h)).astype(np.float32)
    b = rng.normal(0, 0.01, h).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (x, mean, std, w, b)]


K1_SHAPES = ((1, 512, NN_IN, NN_HIDDEN[0]), (2, 65536, NN_IN, NN_HIDDEN[0]),
             (3, 37, 37, 16), (4, 1, 20, 1), (5, 512, 20, 1))


def phase_k1(report, device="cuda"):
    import torch
    from shifu_tpu_torch.ops import fused_score as fs
    errs = []
    for seed, n, c, h in K1_SHAPES:
        x, mean, std, w, b = k1_inputs(seed, n, device, c, h)
        got = fs.fused_first_layer(x, mean, std, CUTOFF, w, b)
        again = fs.fused_first_layer(x, mean, std, CUTOFF, w, b)
        want = fs.fused_first_layer_plain(x, mean, std, CUTOFF, w, b)
        if device == "cuda":
            torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "K1 output not finite"
        assert torch.equal(got, again), \
            f"K1 {n}x{c}->{h}: two launches differ"
        errs.append(check_close(f"K1 fused_score {n}x{c}->{h} (plan "
                                f"{tuple(fs._k1_plan(n, c, h))}, two "
                                "launches bit-identical)", got, want,
                                1e-5, 1e-5))
    report["fused_score"] = {"max_abs_err": max(errs)}


def k2_inputs(seed, r, device, kind="gbt", loss="log", t=GBT_TREES):
    import torch
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.models import gbdt
    rng = np.random.default_rng(seed)
    meta, params = tree_model(rng, kind, loss, t)
    ens = weights.to_torch(kind, meta, params, device)
    x = tree_rows(rng, r)
    fb = gbdt.make_fused_inputs(ens.tables, x, None, GBT_BINS,
                                device=device)
    # one +inf pad column in the cuts, as make_fused_inputs pads widths
    cuts = torch.nn.functional.pad(fb.cuts, (0, 1), value=math.inf)
    return ens.nodes, fb.valuesT, cuts.contiguous(), ens.statics


def phase_k2(report, device="cuda"):
    import torch
    from shifu_tpu_torch.ops import fused_trees as ft
    errs = []
    for seed, r, kind, loss in ((3, 512, "gbt", "log"),
                                (4, 512, "rf", "squared"),
                                (5, 1 << 20, "gbt", "log")):
        nodes, vT, cuts, kw = k2_inputs(seed, r, device, kind, loss)
        got, leaves = ft.predict_ensemble(nodes, vT, cuts, **kw,
                                          return_leaves=True)
        want, want_leaves = ft.predict_ensemble_plain(
            nodes, vT, cuts, **kw, return_leaves=True)
        if device == "cuda":
            torch.cuda.synchronize()
        assert torch.equal(leaves, want_leaves), \
            f"K2 {kind} R={r}: landing leaves differ from the plain walk"
        assert torch.isfinite(got).all(), "K2 output not finite"
        errs.append(check_close(f"K2 fused_trees {kind} R={r} (leaves "
                                "exact)", got, want, 1e-6, 1e-6))
    report["fused_trees"] = {"max_abs_err": max(errs)}


def _post(base, blocks):
    body = json.dumps({k: np.where(np.isfinite(v), v, None).tolist()
                       if v.dtype.kind == "f" else v.tolist()
                       for k, v in blocks.items()}).encode()
    req = urllib.request.Request(base + "/score", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["scores"]


def _serve_and_compare(name, gpu, cpu, base, make_rows, tol, seed,
                       reps=3):
    """Requests of every size: `reps` at once in process (so they share
    batches), one over HTTP; each answer against the CPU twin."""
    rng = np.random.default_rng(seed)
    for n in SIZES:
        batch = [make_rows(rng, n) for _ in range(reps)]
        reqs = [gpu.submit_async(**b) for b in batch]
        for b, req in zip(batch, reqs):
            got = req.wait(120)
            want = cpu.submit(**b, timeout=120)
            for k in want:
                assert got[k].shape == (n,) and np.isfinite(got[k]).all()
                np.testing.assert_allclose(got[k], want[k], **tol,
                                           err_msg=f"{name} n={n} {k}")
        over_http = _post(base, batch[0])
        # JSON has no inf/NaN: the HTTP request sends them as null →
        # NaN, so the HTTP answer is held against the CPU twin's answer
        # to the same NaN-for-inf rows
        json_blocks = {k: np.where(np.isfinite(v), v, np.nan)
                       .astype(v.dtype) for k, v in batch[0].items()}
        want = cpu.submit(**json_blocks, timeout=120)
        for k in want:
            np.testing.assert_allclose(np.asarray(over_http[k]), want[k],
                                       **tol, err_msg=f"{name} http n={n}")
    print(f"  {name}: served sizes {list(SIZES)} in process and over "
          "HTTP, matching the CPU twin")
    # a closed loop of one client for the percentiles: STREAM requests
    # per size, each sent when the previous one returned
    stages = ("queue_s", "pad_s", "h2d_s", "device_s", "d2h_s")
    out = {}
    for n in SIZES:
        rows = [make_rows(rng, n) for _ in range(8)]
        lat, split = [], {k: 0.0 for k in stages}
        for i in range(STREAM):
            _, timing = gpu.submit_timed(**rows[i % len(rows)])
            lat.append(timing["total_s"] * 1e3)
            for k in stages:
                split[k] += timing[k] * 1e3 / STREAM
        out[n] = {"n": STREAM, "p50_ms": float(np.percentile(lat, 50)),
                  "p95_ms": float(np.percentile(lat, 95)),
                  "p99_ms": float(np.percentile(lat, 99)),
                  "mean_stage_ms": split}
        if gpu.device.type == "cuda":
            # the device's idle share over a profiled closed-loop window
            wall, busy = device_busy(lambda: [
                gpu.submit_timed(**rows[i % len(rows)])
                for i in range(IDLE_WINDOW)])
            out[n]["idle_window"] = {"requests": IDLE_WINDOW,
                                     "wall_ms": wall, "device_ms": busy,
                                     "idle_share": 1.0 - busy / wall}
    return out


def serving_sets(workdir, rng):
    """The two model sets the services serve, written with the port's
    `save_model` from `rng`: (NN dir, trees dir, norm, NN request maker,
    trees request maker)."""
    from shifu_tpu_torch.models.spec import save_model
    nn_dir = os.path.join(workdir, "nn", "models")
    tree_dir = os.path.join(workdir, "trees", "models")
    save_model(os.path.join(nn_dir, "model0.nn"), "nn",
               {"spec": {"input_dim": NN_IN, "hidden_dims": list(NN_HIDDEN),
                         "activations": ["relu", "relu"]}},
               nn_params(rng))
    for i, (kind, loss) in enumerate((("gbt", "log"), ("rf", "squared"))):
        meta, params = tree_model(rng, kind, loss)
        save_model(os.path.join(tree_dir, f"model{i}.{kind}"), kind, meta,
                   params)
    mean, std = norm_params(rng)
    norm = {"mean": mean, "std": std, "cutoff": CUTOFF}

    def nn_rows(r, n):
        return {"raw_dense": raw_rows(r, n, mean, std)}

    def tree_req(r, n):
        return {"raw_dense": tree_rows(r, n)}
    return nn_dir, tree_dir, norm, nn_rows, tree_req


def phase_main_path(report, workdir, device="cuda"):
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    from shifu_tpu_torch.serve.service import ScorerService

    rng = np.random.default_rng(42)
    nn_dir, tree_dir, norm, nn_rows, tree_req = serving_sets(workdir, rng)

    services, fronts = [], []
    try:
        nn_gpu = ScorerService(models_dir=nn_dir, norm=norm,
                               max_delay=0.002, device=device)
        nn_cpu = ScorerService(models_dir=nn_dir, norm=norm,
                               max_delay=0.002, device="cpu")
        tr_gpu = ScorerService(models_dir=tree_dir, max_delay=0.002,
                               device=device)
        tr_cpu = ScorerService(models_dir=tree_dir, max_delay=0.002,
                               device="cpu")
        services = [nn_gpu, nn_cpu, tr_gpu, tr_cpu]
        for svc, proto in ((nn_gpu, nn_rows(rng, 1)),
                           (nn_cpu, nn_rows(rng, 1)),
                           (tr_gpu, tree_req(rng, 1)),
                           (tr_cpu, tree_req(rng, 1))):
            svc.start(proto=proto)
        fronts = [HttpFrontEnd(s, host="127.0.0.1", port=0).start()
                  for s in (nn_gpu, tr_gpu)]
        bases = ["http://%s:%d" % f.address for f in fronts]

        fused_score.launches = 0
        fused_trees.launches = 0
        lat_nn = _serve_and_compare("nn+norm", nn_gpu, nn_cpu, bases[0],
                                    nn_rows, dict(rtol=1e-5, atol=1e-5), 7)
        lat_tr = _serve_and_compare("gbt+rf", tr_gpu, tr_cpu, bases[1],
                                    tree_req, dict(rtol=1e-6, atol=1e-6), 8)
        launches = {"fused_score": fused_score.launches,
                    "fused_trees": fused_trees.launches}
        for k, v in launches.items():
            assert v > 0, f"kernel {k} was not launched on the main path"
            report[k]["launches"] = v
        report["services"] = {
            "nn+norm": {"per_size": lat_nn,
                        "overall": nn_gpu.stats()["latency"],
                        "batcher": nn_gpu.stats()["batcher"]},
            "gbt+rf": {"per_size": lat_tr,
                       "overall": tr_gpu.stats()["latency"],
                       "batcher": tr_gpu.stats()["batcher"]}}
    finally:
        for f in fronts:
            f.close()
        for s in services:
            s.close()


K1_SWEEP = (1, 8, 64, 512, 65536)          # the serving buckets, eval
K2_SWEEP = (1, 64, 512, 1 << 20)


K1_PLANS = ((128, 128, 1), (128, 128, 2), (128, 128, 4), (128, 128, 8),
            (64, 64, 8))


def k1_plan_sweep(n):
    """K1 at `n` rows under each of K1_PLANS in place of `_k1_plan`'s
    choice, each checked against the plain version: the evidence for
    the plan's block target."""
    import torch
    from shifu_tpu_torch.ops import fused_score as fs
    x, mean, std, w, b = k1_inputs(11, n, "cuda")
    packed, wp = fs.pack_norm(mean, std, CUTOFF), fs.pack_weights(w)
    want = fs.fused_first_layer_plain(x, mean, std, CUTOFF, w, b)
    chosen, rows = fs._k1_plan, []

    def kernel():
        return fs.fused_first_layer(x, mean, std, CUTOFF, w, b, packed, wp)
    try:
        for plan in K1_PLANS:
            fs._k1_plan = lambda *a, p=plan: fs.K1Plan(*p)
            fs._launches.clear()
            torch.testing.assert_close(kernel(), want, rtol=1e-5, atol=1e-5)
            rows.append({"name": "fused_score plan", "shape": f"{n}x{NN_IN}x"
                         f"{NN_HIDDEN[0]}", "plan": list(plan),
                         "blocks": fs.K1Plan(*plan).blocks(n, NN_HIDDEN[0]),
                         "chosen": plan == tuple(chosen(n, NN_IN,
                                                        NN_HIDDEN[0])),
                         "ms": cuda_ms(kernel, 200),
                         "kernel_device_ms": kernel_device_ms(
                             kernel, 200, "fused_score_kernel")})
    finally:
        fs._k1_plan = chosen
        fs._launches.clear()
    return rows


def phase_timing(report):
    import torch
    from shifu_tpu_torch.ops import fused_score as fs
    from shifu_tpu_torch.ops import fused_trees as ft
    from shifu_tpu_torch.ops.normalize import zscore

    assert not torch.backends.cuda.matmul.allow_tf32
    sweep = []
    for n in K1_SWEEP:
        x, mean, std, w, b = k1_inputs(11, n, "cuda")
        packed = fs.pack_norm(mean, std, CUTOFF)
        wp = fs.pack_weights(w)
        z = zscore(x, mean, std, CUTOFF)
        iters = 200 if n <= 512 else 20

        def kernel():
            return fs.fused_first_layer(x, mean, std, CUTOFF, w, b, packed,
                                        wp)
        ms = cuda_ms(kernel, iters)
        plain = cuda_ms(lambda: fs.fused_first_layer_plain(
            x, mean, std, CUTOFF, w, b), iters)
        lib = cuda_ms(lambda: torch.matmul(z, w), iters)
        dev = kernel_device_ms(kernel, iters, "fused_score_kernel")
        bnd, by = k1_tf32_bound_ms(n, NN_IN, NN_HIDDEN[0])
        f32, f32_by = bound_ms(*k1_cost(n, NN_IN, NN_HIDDEN[0]))
        sweep.append({"name": "fused_score", "shape": f"{n}x{NN_IN}x"
                      f"{NN_HIDDEN[0]}", "plan": list(fs._k1_plan(
                          n, NN_IN, NN_HIDDEN[0])),
                      "ms": ms, "kernel_device_ms": dev,
                      "plain_ms": plain, "library_ms": lib,
                      "library": "torch.matmul(z, w), f32, allow_tf32 "
                      "False", "bound_ms": bnd, "bound_by": by,
                      "bound_f32_ms": f32, "bound_f32_by": f32_by})
    sweep += k1_plan_sweep(512)
    for r in K2_SWEEP:
        nodes, vT, cuts, kw = k2_inputs(12, r, "cuda")
        pack = ft.pack_nodes(nodes, kw["n_trees"])
        _, leaves = ft.predict_ensemble_plain(nodes, vT, cuts, **kw,
                                              return_leaves=True)
        iters = 200 if r <= 512 else 20

        def kernel():
            return ft.predict_ensemble(nodes, vT, cuts, **kw,
                                       node_pack=pack)
        ms = cuda_ms(kernel, iters)
        plain = cuda_ms(lambda: ft.predict_ensemble_plain(nodes, vT, cuts,
                                                          **kw), iters)
        dev = kernel_device_ms(kernel, iters, "fused_trees_")
        bnd, by = bound_ms(*k2_cost(vT.shape[0], r, cuts.shape[1],
                                    nodes.shape[1], kw["n_trees"], leaves))
        plan = ft._k2_plan(r, vT.shape[0], cuts.shape[1], kw["n_trees"],
                           nodes.shape[1] // kw["n_trees"])
        sweep.append({"name": "fused_trees", "shape": f"R={r}x{GBT_COLS}"
                      f" T={GBT_TREES} d={GBT_DEPTH}",
                      "layout": "rows" if plan.layout == ft.LAYOUT_ROWS
                      else "warps", "ms": ms, "kernel_device_ms": dev,
                      "plain_ms": plain, "library_ms": None,
                      "bound_ms": bnd, "bound_by": by})
    for row in sweep:
        print("  timing " + json.dumps(row))
    # the main path's shape: the top serving bucket (512 rows)
    for row in sweep:
        if row["name"] in report and row["shape"].startswith(
                ("512x", "R=512x")):
            report[row["name"]].update({k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    report["sweep"] = sweep


# ---------------------------------------------------------------------------
# The tree-training slice: K3, K4 and K5, and `train` on the card
# ---------------------------------------------------------------------------

HIGGS_ROWS, HIGGS_TREES = 2_000_000, 10     # bench.py:178-179 (GBT_SMALL)
BIG_ROWS, BIG_TREES = 11_000_000, 20        # bench.py:171-176 (HIGGS)
TRAIN_ROWS = 262_144                        # the main path's model sets
TRAIN_DEPTH, TRAIN_LR = 6, 0.2
HIST_SLOTS = (1, 32)          # root level; leaf level with subtraction
LIMIT_S = 1200.0


def hist_inputs(seed, r, n_slots, device, integer, c=GBT_COLS,
                n_bins=GBT_BINS):
    """Raw (C, R) values with NaN and ±inf, (C, B-2) quantile cuts, their
    bins, and per-row slot (dump slot S and -1 included) / grad / hess,
    made on `device` from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((c, r), generator=gen, device=device)
    u = torch.rand((c, r), generator=gen, device=device)
    vals[u < 0.05] = math.nan
    vals[u > 0.998] = math.inf
    vals[(u > 0.996) & (u <= 0.998)] = -math.inf
    qs = torch.linspace(0, 1, n_bins, device=device)[1:-1]
    sample = torch.randn(20000, generator=gen, device=device)
    cuts = torch.quantile(sample, qs).expand(c, n_bins - 2).contiguous()
    from shifu_tpu_torch.ops.level_hist import bins_from_values_plain
    binsT = bins_from_values_plain(vals, cuts, n_bins)
    slot = torch.randint(-1, n_slots + 1, (r,), generator=gen,
                         device=device, dtype=torch.int32)
    if integer:
        grad = torch.randint(-3, 4, (r,), generator=gen,
                             device=device).float()
        hess = torch.randint(0, 3, (r,), generator=gen,
                             device=device).float()
    else:
        grad = torch.randn(r, generator=gen, device=device)
        hess = torch.rand(r, generator=gen, device=device)
    return vals, cuts, binsT, slot, grad, hess


def _hist_err(name, got, want, slot, w, n_slots, integer):
    """Exact for integer weights; otherwise |err| ≤ 1e-5·Σ|w| per slot."""
    import torch
    if integer:
        assert torch.equal(got, want), f"{name}: not bit-exact"
        print(f"  {name}: bit-exact")
        return 0.0
    ok = (slot >= 0) & (slot < n_slots)
    per_slot = torch.zeros(n_slots, dtype=torch.float64, device=w.device)
    per_slot.index_add_(0, slot[ok].long(), w[ok].abs().double())
    err = (got - want).abs().amax(dim=(1, 2)).double()
    tol = 1e-5 * per_slot
    assert bool((err <= tol).all()), \
        f"{name}: per-slot max |err| {err.tolist()} over {tol.tolist()}"
    print(f"  {name}: max |err| {float(err.max()):.3g} (≤ 1e-5·Σ|w| per "
          f"slot, tightest {float(tol.min()):.3g}) ok")
    return float(err.max())


def phase_k3_k4(report, device="cuda", r=HIGGS_ROWS):
    import torch
    from shifu_tpu_torch.ops import level_hist as lh
    errs = {"level_hist": [0.0], "level_hist_fused": [0.0]}
    for s in HIST_SLOTS:
        for integer in (True, False):
            vals, cuts, binsT, slot, grad, hess = hist_inputs(
                20 + s + integer, r, s, device, integer)
            kind = "int" if integer else "real"
            want = lh.level_histograms_plain(binsT, slot, grad, hess, s,
                                             GBT_BINS)
            runs = (("level_hist", "int32", lh.level_histograms(
                        binsT, slot, grad, hess, s, GBT_BINS)),
                    ("level_hist", "uint8", lh.level_histograms(
                        binsT.to(torch.uint8), slot, grad, hess, s,
                        GBT_BINS)),
                    ("level_hist_fused", "values",
                     lh.level_histograms_fused(vals, cuts, slot, grad,
                                               hess, s, GBT_BINS)))
            for name, how, got in runs:
                for part, g, wv, w in zip("GH", got, want, (grad, hess)):
                    errs[name].append(_hist_err(
                        f"{name} ({how}) R={r} S={s} {kind} {part}", g, wv,
                        slot, w, s, integer))
            if integer:
                k3, k4 = runs[1][2], runs[2][2]
                assert torch.equal(k3[0], k4[0]) and \
                    torch.equal(k3[1], k4[1]), "K4 differs from K3"
                print(f"  K4 equals K3 over the same bins at S={s}")
            elif s == max(HIST_SLOTS):
                # fixed-point adds: a second launch gives the same bits
                again = (lh.level_histograms(binsT, slot, grad, hess, s,
                                             GBT_BINS),
                         lh.level_histograms(binsT.to(torch.uint8), slot,
                                             grad, hess, s, GBT_BINS),
                         lh.level_histograms_fused(vals, cuts, slot, grad,
                                                   hess, s, GBT_BINS))
                for (name, how, got), two in zip(runs, again):
                    assert torch.equal(got[0], two[0]) and \
                        torch.equal(got[1], two[1]), \
                        f"{name} ({how}): two launches differ at S={s}"
                print(f"  two launches of each bit-identical at S={s} on "
                      "real-valued grads")
    for name, e in errs.items():
        report[name] = {"max_abs_err": max(e)}


def k3_timing(r=HIGGS_ROWS, iters=20):
    """K3 (uint8 and int32 bins) and K4 at R × 28 × 64, S = 1 and 32, on
    real-valued grads: the wrapper's ms by CUDA events and the kernel's
    by `torch.profiler`. It calls only what older trees of the port have
    too, so the script copied into an older tree times that tree's
    kernels (`--k3-timing`)."""
    import torch
    from shifu_tpu_torch.ops import level_hist as lh
    out = []
    for s in HIST_SLOTS:
        vals, cuts, binsT, slot, grad, hess = hist_inputs(7 + s, r, s,
                                                          "cuda", False)
        b8 = binsT.to(torch.uint8)
        for name, fn in (
                ("level_hist uint8", lambda: lh.level_histograms(
                    b8, slot, grad, hess, s, GBT_BINS)),
                ("level_hist int32", lambda: lh.level_histograms(
                    binsT, slot, grad, hess, s, GBT_BINS)),
                ("level_hist_fused", lambda: lh.level_histograms_fused(
                    vals, cuts, slot, grad, hess, s, GBT_BINS))):
            out.append({"name": name, "shape": f"R={r}x{GBT_COLS} S={s} "
                        f"B={GBT_BINS}", "ms": cuda_ms(fn, iters),
                        "kernel_device_ms": kernel_device_ms(
                            fn, iters, "level_hist_kernel")})
        del vals, cuts, binsT, b8, slot, grad, hess
    return out


def split_inputs(seed, n, device, c=GBT_COLS, n_bins=GBT_BINS,
                 integer=True, mask_rows=None):
    """(N, C, B) G/H and a feature mask, made on `device` from a seed:
    integer-valued (every cumsum exact) or real-valued (G normal, H in
    [0.05, 1)); a planted tie (column 5 repeats column 2, two columns
    whose cells different warps score) when C > 5; and, where N > 1 and
    the mask has more than one row, an all-masked node 0 (row 0 off).
    The mask has `mask_rows` rows (a forest's (T, C), the GBT builder's
    (1, C); N rows by default, a (C,) vector for N = 1), node i reading
    row i // (N/M)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    if integer:
        g = torch.randint(-20, 21, (n, c, n_bins), generator=gen,
                          device=device).float()
        h = torch.randint(0, 30, (n, c, n_bins), generator=gen,
                          device=device).float()
    else:
        g = torch.randn((n, c, n_bins), generator=gen, device=device)
        h = torch.rand((n, c, n_bins), generator=gen, device=device) \
            * 0.95 + 0.05
    m = mask_rows or n
    mask = (torch.rand((m, c), generator=gen, device=device) < 0.8).float()
    if c > 5:
        g[:, 5] = g[:, 2]
        h[:, 5] = h[:, 2]
        mask[:, 2] = 1.0
        mask[:, 5] = 1.0
    if n > 1 and m > 1:
        mask[0] = 0.0
    return g, h, mask[0] if n == 1 and mask_rows is None else mask


def k5_sequential(g, h, mask, lam, min_inst):
    """K5's function with each column's left sums added bin by bin in
    f32 — ((b0 + b1) + …) + bj, the kernel's order — and then the plain
    chain's gain operations, one PyTorch op each: what the kernel must
    return bit for bit."""
    import torch
    n, c, b = g.shape
    gl = torch.empty_like(g[:, :, :-1])
    hl = torch.empty_like(gl)
    sg = torch.zeros((n, c), dtype=g.dtype, device=g.device)
    sh = torch.zeros_like(sg)
    for j in range(b - 1):
        sg = sg + g[:, :, j]
        sh = sh + h[:, :, j]
        gl[:, :, j] = sg
        hl[:, :, j] = sh
    g_miss, h_miss = g[:, :, -1], h[:, :, -1]
    g_tot, h_tot = sg + g_miss, sh + h_miss
    parent = g_tot * g_tot / (h_tot + lam)
    neg_inf = torch.tensor(-math.inf, device=g.device)

    def gain_of(gl_, hl_):
        gr_ = g_tot[:, :, None] - gl_
        hr_ = h_tot[:, :, None] - hl_
        left = gl_ * gl_ / (hl_ + lam)
        right = gr_ * gr_ / (hr_ + lam)
        score = left + right - parent[:, :, None]
        return torch.where((hl_ >= min_inst) & (hr_ >= min_inst), score,
                           neg_inf)

    gain_left = gain_of(gl + g_miss[:, :, None], hl + h_miss[:, :, None])
    gain_right = gain_of(gl, hl)
    dl = gain_left >= gain_right
    gain = torch.maximum(gain_left, gain_right)
    rows = mask.reshape(-1, c)
    on = torch.repeat_interleave(rows, n // rows.shape[0], dim=0) > 0
    gain = torch.where(on[:, :, None], gain, neg_inf)
    gain[:, :, -1] = -math.inf
    flat = gain.reshape(n, -1)
    best = torch.argmax(flat, dim=1)
    bm = b - 1
    return {"feature": (best // bm).to(torch.int32),
            "bin": (best % bm).to(torch.int32),
            "gain": flat.gather(1, best[:, None])[:, 0],
            "default_left": dl.reshape(n, -1).gather(1, best[:, None])[:, 0],
            "g_tot": g_tot[:, 0], "h_tot": h_tot[:, 0]}


def same_bits(got, want):
    """The names of the `best_splits` outputs whose dtype, shape or bits
    differ (float outputs compared as their int32 bit patterns, NaNs
    included)."""
    import torch
    bad = []
    for k, w in want.items():
        a = got[k]
        if a.dtype != w.dtype or a.shape != w.shape:
            bad.append(k)
        elif a.dtype == torch.float32:
            if not torch.equal(a.view(torch.int32), w.view(torch.int32)):
                bad.append(k)
        elif not torch.equal(a, w):
            bad.append(k)
    return bad


# (N, mask rows): one tree's root ((C,) mask), its leaf level (the GBT
# builder's one (1, C) mask for every node, and a mask a node), and a
# 20-tree forest's level ((T, C) masks)
K5_SHAPES = ((1, None), (32, 1), (32, 32), (640, 20))


def phase_k5(report, device="cuda"):
    """Integer-valued histograms against the plain version, real-valued
    ones against `k5_sequential`, every output bit for bit, with the tie
    and all-masked gates."""
    import torch
    from shifu_tpu_torch.ops import best_splits as bs
    cases = [(n, m, GBT_COLS, GBT_BINS, True) for n, m in K5_SHAPES] + [
        (n, m, c, b, False) for n, m in K5_SHAPES for c in (GBT_COLS, 300)
        for b in (GBT_BINS, 256)]
    err = 0.0
    for n, m, c, b, integer in cases:
        g, h, mask = split_inputs(30 + n + c + b, n, device, c, b, integer,
                                  m)
        got = bs.best_splits(g, h, mask, 1.0, 2.0)
        want = (bs.best_splits_plain if integer else k5_sequential)(
            g, h, mask, 1.0, 2.0)
        what = f"K5 N={n} C={c} B={b} mask {tuple(mask.shape)} " + (
            "integer vs plain" if integer else "real vs sequential f32")
        bad = same_bits(got, want)
        assert not bad, f"{what}: {bad} differ"
        for k in ("gain", "g_tot", "h_tot"):
            fin = torch.isfinite(want[k])
            if bool(fin.any()):
                err = max(err, float((got[k][fin] - want[k][fin]).abs()
                                     .max()))
        assert not bool((got["feature"] == 5).any()), \
            f"{what}: the tie went to the later column"
        if n > 1 and mask.shape[0] > 1:
            assert got["gain"][0] == -math.inf and got["feature"][0] == 0 \
                and got["bin"][0] == 0, \
                f"{what}: all-masked node not at index 0"
        print(f"  {what}: every output bit-exact")
    report["best_splits"] = {"max_abs_err": err}


def raw_table(rng, rows, extras):
    """The HIGGS-shaped raw table as string columns: 28 numeric columns
    (`bench.py:171-174`) whose label depends on a few of them, with
    `extras` 2 categorical columns, a weight and a meta column too; 2 %
    of the values are the missing token "?". Floats are written with
    their shortest float32 text, so `strtof` reads back the same bits.
    Returns (names, columns, x, y)."""
    x = rng.normal(0, 1, (rows, GBT_COLS)).astype(np.float32)
    logit = (x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
             + np.where(x[:, 4] > 0.5, 1.0, -0.3)
             + rng.logistic(0, 1, rows))
    y = (logit > 0).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    text = np.where(np.isnan(x), "?", x.astype(str))
    names = [f"f{j}" for j in range(GBT_COLS)]
    cols = [text[:, j] for j in range(GBT_COLS)]
    if extras:
        cats = np.array(["aa", "bb", "cc", "dd", "ee"])
        for j in range(2):
            p = np.where(y[:, None] > 0.5, [0.4, 0.3, 0.15, 0.1, 0.05],
                         [0.1, 0.15, 0.2, 0.25, 0.3])
            pick = (rng.random(rows)[:, None] > np.cumsum(p, 1)).sum(1)
            c = cats[np.minimum(pick, 4)].astype("<U2")
            c[rng.random(rows) < 0.02] = "?"
            names.append(f"c{j}")
            cols.append(c)
        names += ["w", "id"]
        cols += [np.round(rng.uniform(0.5, 2.0, rows), 4).astype(str),
                 np.arange(rows).astype(str)]
    names.append("label")
    cols.append(np.where(y > 0.5, "1", "0"))
    return names, cols, x, y


def cohort_columns(rng, names, cols):
    """Phase 13's two meta columns, put before the label: `month`, the
    PSI cohort (six months, the later ones rarer and drifting in f0),
    and `day`, the DateStats date (60 days)."""
    rows = len(cols[0])
    month = rng.choice(6, rows, p=[0.25, 0.2, 0.2, 0.15, 0.1, 0.1])
    day = rng.integers(0, 60, rows)
    f0 = cols[0].copy()
    shift = (month >= 4) & (f0 != "?")
    f0[shift] = (f0[shift].astype(np.float32) + np.float32(0.5)).astype(str)
    cols = [f0] + cols[1:-1] + [
        np.array([f"2024-{m + 1:02d}" for m in range(6)])[month],
        np.array([f"2024-d{d:02d}" for d in range(60)])[day], cols[-1]]
    return names[:-1] + ["month", "day", names[-1]], cols


def write_model_set(root, alg, params, seed, rows, valid_rate,
                    extras=False, cohorts=False):
    """A model set as a user starts one: raw pipe-delimited data with a
    `.pig_header` under ``data/`` and `ModelConfig.json`, from a seed;
    `init → stats → norm` make the rest. Its paths are absolute, so a
    copy without ``data/`` reads the same raw files. With `cohorts`
    (and `extras`), the table gains phase 13's `month` and `day` meta
    columns, named as `stats#psiColumnName` and `dataSet#dateColumnName`.
    Returns the raw table's bytes."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fileio import atomic_write
    data_dir = os.path.join(root, "data")
    rng = np.random.default_rng(seed)
    names, cols, _, _ = raw_table(rng, rows, extras)
    if cohorts:
        names, cols = cohort_columns(rng, names, cols)
    raw_bytes = write_raw(data_dir, names, cols)
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["1"],
                "negTags": ["0"]}
    if extras:
        cols_dir = os.path.join(root, "columns")
        os.makedirs(cols_dir, exist_ok=True)
        meta = "id\nmonth\nday\n" if cohorts else "id\n"
        for fname, names_in in (("categorical.column.names", "c0\nc1\n"),
                                ("meta.column.names", meta)):
            with atomic_write(os.path.join(cols_dir, fname)) as f:
                f.write(names_in)
        data_set.update({
            "weightColumnName": "w",
            "categoricalColumnNameFile": os.path.join(
                cols_dir, "categorical.column.names"),
            "metaColumnNameFile": os.path.join(cols_dir,
                                               "meta.column.names")})
    stats = {"maxNumBin": GBT_BINS - 1, "binningMethod": "EqualPositive"}
    if cohorts:
        data_set["dateColumnName"] = "day"
        stats["psiColumnName"] = "month"
    ModelConfig.from_dict({
        "basic": {"name": f"smoke{alg}"}, "dataSet": data_set,
        "stats": stats, "normalize": {"normType": "ZSCALE"},
        "train": {"algorithm": alg, "validSetRate": valid_rate,
                  "params": params}}).save(root)
    return raw_bytes


def write_raw(data_dir, names, cols, chunk=8192):
    """One pipe-delimited part file of string columns (a list of 1-D
    arrays, or one 2-D array of tokens), written `chunk` rows at a time,
    with its `.pig_header`; returns the part file's bytes."""
    from shifu_tpu_torch.fileio import atomic_write
    os.makedirs(data_dir)
    tokens = cols if isinstance(cols, np.ndarray) else np.stack(cols, 1)
    n_bytes = 0
    with atomic_write(os.path.join(data_dir, "part-00000")) as f:
        for a in range(0, len(tokens), chunk):
            body = "\n".join("|".join(r)
                             for r in tokens[a:a + chunk].tolist()) + "\n"
            f.write(body)
            n_bytes += len(body)
    with atomic_write(os.path.join(data_dir, ".pig_header")) as f:
        f.write("|".join(names) + "\n")
    return n_bytes


def set_config(root, section, **fields):
    """Rewrite fields of one ModelConfig section (e.g. the norm type or
    the train params) through the port's own config writer."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        d = json.load(f)
    d.setdefault(section, {}).update(fields)
    ModelConfig.from_dict(d).save(root)


def _spawn(args, env_extra=None):
    """`python <args>` from the repo's root, its output piped."""
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def _start_step(root, verb, device, env_extra):
    args = [verb] if isinstance(verb, str) else list(verb)
    if device is not None:
        args += ["--device", device]
    return _spawn(["-m", "shifu_tpu_torch", "--dir", root, *args], env_extra)


def _step_result(proc, what):
    try:
        out, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {proc.returncode}):\n"
                           f"{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def run_step(root, verb, device=None, env_extra=None):
    """`python -m shifu_tpu_torch --dir root <verb> [--device D]` as a
    subprocess (`verb` a word or a list of arguments); returns its JSON
    line."""
    return _step_result(_start_step(root, verb, device, env_extra),
                        f"{verb} --device {device} on {root}")


def in_parallel(*fns):
    """Call each function on a thread of its own, all at once; return
    their results in order (the first failure raises, after all have
    ended). The chains of step processes that touch separate model sets
    run side by side this way, for the gates: their step lines time a
    shared host, so the step times come from `--eval-walls` and
    `--pipeline-walls`."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result() for f in futures]


# a CPU twin runs on four threads beside the card's steps
CPU_TWIN_ENV = {"OMP_NUM_THREADS": "4"}


def beside(procs, card_fn):
    """Call `card_fn` while the CPU twin's processes run (`procs`, each
    a (process, what) pair from `_spawn`); returns (its result, each
    process's JSON line). A failure on either side kills every twin
    process still running."""
    cpu = []
    try:
        card = card_fn()
        for proc, what in procs:
            cpu.append(_step_result(proc, what))
    except BaseException:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        raise
    return card, cpu


def run_twins(card_root, cpu_root, verb, device="cuda"):
    """`verb` on `device` in `card_root` and with `--device cpu` in
    `cpu_root`, the CPU twin started first and run `beside` the card one,
    for the gates (`in_parallel` says where the step times come from);
    returns (card line, CPU line)."""
    cpu = _start_step(cpu_root, verb, "cpu", CPU_TWIN_ENV)
    card, (line,) = beside([(cpu, f"{verb} --device cpu on {cpu_root}")],
                           lambda: run_step(card_root, verb, device))
    return card, line


def run_pipeline(root, device, norms=("ZSCALE",), env_extra=None):
    """`init`, `stats` and one `norm` a norm type, each in its own
    process; returns their JSON lines (norm lines keyed by type). With
    several norm types, each type's NormalizedData is kept as
    ``tmp/NormalizedData.<type>``."""
    import shutil
    lines = {"init": run_step(root, "init", env_extra=env_extra),
             "stats": run_step(root, "stats", device, env_extra)}
    for nt in norms:
        set_config(root, "normalize", normType=nt)
        lines[f"norm {nt}"] = run_step(root, "norm", device, env_extra)
        if len(norms) > 1:
            out = os.path.join(root, "tmp", "NormalizedData")
            shutil.move(out, f"{out}.{nt}")
    return lines


# ColumnConfig fields held card against CPU within (rtol, atol): the f32
# sums and the metrics of the weighted sums (KS is in percent); every
# other field must be equal
CC_TOL = {"mean": (1e-5, 0.0), "stdDev": (1e-5, 0.0),
          "binWeightedPos": (1e-5, 0.0), "binWeightedNeg": (1e-5, 0.0),
          "skewness": (0.0, 1e-4), "kurtosis": (0.0, 1e-4),
          "binWeightedWoe": (1e-5, 1e-6), "weightedKs": (1e-5, 1e-4),
          "weightedIv": (1e-5, 1e-6), "weightedWoe": (1e-5, 1e-6)}


def compare_column_configs(card_root, cpu_root):
    """ColumnConfig.json card against CPU under `CC_TOL`; the weighted
    metrics must also be the host function of the card's own weighted
    sums (rtol 1e-9). Returns each tolerance field's largest relative
    difference; raises, naming every field out of tolerance."""
    from shifu_tpu_torch.ops.stats import column_metrics
    with open(os.path.join(card_root, "ColumnConfig.json")) as f:
        card = json.load(f)
    with open(os.path.join(cpu_root, "ColumnConfig.json")) as f:
        cpu = json.load(f)
    assert [c["columnName"] for c in card] == [c["columnName"] for c in cpu]
    worst, bad = {k: 0.0 for k in CC_TOL}, []
    for a, b in zip(card, cpu):
        name = a["columnName"]
        for k in a:
            if k not in ("columnStats", "columnBinning") and a[k] != b[k]:
                bad.append(f"{name}.{k}: {a[k]} vs {b[k]}")
        fields = {**a["columnStats"], **a["columnBinning"]}
        ref = {**b["columnStats"], **b["columnBinning"]}
        for k, v in fields.items():
            w = ref[k]
            if k in CC_TOL and v is not None and w is not None:
                va, vb = np.asarray(v, float), np.asarray(w, float)
                rtol, atol = CC_TOL[k]
                if va.size:
                    worst[k] = max(worst[k], float(np.nanmax(
                        np.abs(va - vb) / np.maximum(np.abs(vb), 1e-30))))
                if not np.allclose(va, vb, rtol=rtol, atol=atol,
                                   equal_nan=True):
                    bad.append(f"{name}.{k}: {v} vs {w}")
            elif v != w:
                bad.append(f"{name}.{k}: {v} vs {w}")
        if fields["binWeightedPos"] is not None:
            wks, wiv, wwoe, wbin = column_metrics(fields["binWeightedPos"],
                                                  fields["binWeightedNeg"])
            for k, want in (("weightedKs", wks), ("weightedIv", wiv),
                            ("weightedWoe", wwoe)):
                if want is not None and abs(fields[k] - want) > \
                        1e-9 * abs(want):
                    bad.append(f"{name}.{k} is not its sums' metric")
            if not np.allclose(fields["binWeightedWoe"], wbin, rtol=1e-9,
                               atol=1e-12):
                bad.append(f"{name}.binWeightedWoe is not its sums' WOE")
    print("  ColumnConfig.json card vs CPU, largest relative difference: "
          + json.dumps(worst))
    assert not bad, "ColumnConfig.json card vs CPU:\n" + "\n".join(bad[:20])
    return worst


def compare_npz(card_dir, cpu_dir, exact):
    """One npz layout card against CPU: every array equal, except the
    dense block of a z-score family (atol 1e-5, rtol 1e-5); meta.json
    equal. Returns the dense block's largest absolute difference."""
    a = np.load(os.path.join(card_dir, "data.npz"))
    b = np.load(os.path.join(cpu_dir, "data.npz"))
    assert set(a) == set(b), (card_dir, set(a), set(b))
    err = 0.0
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if k == "dense" and not exact:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5)
        else:
            assert np.array_equal(a[k], b[k], equal_nan=True), \
                f"{card_dir}: {k} differs between card and CPU"
        if k == "dense" and a[k].size:
            err = float(np.nanmax(np.abs(a[k] - b[k])))
    metas = []
    for d in (card_dir, cpu_dir):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1], f"{card_dir}: meta.json differs"
    return err


def phase_pipeline(report, workdir, device="cuda", rows=TRAIN_ROWS):
    """`init → stats → norm` (ZSCALE, then WOE) on the card against the
    port's CPU twin, on the HIGGS widths plus 2 categorical, a weight
    and a meta column at `rows` rows."""
    import shutil
    card = os.path.join(workdir, "card")
    raw_bytes = write_model_set(card, "GBT", {}, 77, rows, 0.1, extras=True)
    cpu = os.path.join(workdir, "cpu")
    shutil.copytree(card, cpu, ignore=shutil.ignore_patterns("data"))
    norms = ("ZSCALE", "WOE")
    # the CPU twin's steps run on four threads beside the card's
    on_card, on_cpu = in_parallel(
        lambda: run_pipeline(card, device, norms),
        lambda: run_pipeline(cpu, "cpu", norms, CPU_TWIN_ENV))
    lines = {"card": on_card, "cpu": on_cpu}
    for where, steps in lines.items():
        for step, line in steps.items():
            print(f"  {where} {step}: {json.dumps(line)}")
    for step, line in lines["card"].items():
        assert line["rows"] == rows or step == "init", (step, line)
    worst = compare_column_configs(card, cpu)
    errs = {}
    for sub, exact in (("CleanedData", True),
                       *((f"NormalizedData.{nt}", nt == "WOE")
                         for nt in norms)):
        errs[sub] = compare_npz(os.path.join(card, "tmp", sub),
                                os.path.join(cpu, "tmp", sub), exact)
    print("  npz layouts card = CPU; dense max |card - CPU|: "
          + json.dumps(errs))
    report["pipeline"] = {"rows": rows, "raw_bytes": raw_bytes,
                          "steps": lines, "dense_err": errs,
                          "weighted_rel_err": worst}


def pipeline_walls(rows=HIGGS_ROWS):
    """`init`, `stats` and `norm` (ZSCALE) on the card at `rows` rows of
    phase 10's table: each step's read and compute seconds (its wall
    seconds less the raw read; the process start and the card's context
    are outside both)."""
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        root = os.path.join(workdir, "walls")
        t0 = time.perf_counter()
        raw_bytes = write_model_set(root, "GBT", {}, 77, rows, 0.1,
                                    extras=True)
        write_s = time.perf_counter() - t0
        for step, line in run_pipeline(root, "cuda").items():
            read = line.get("read_seconds", 0.0)
            out[step] = {"rows": line["rows"], "read_s": read,
                         "compute_s": line["seconds"] - read,
                         "seconds": line["seconds"]}
    return {"rows": rows, "columns": GBT_COLS + 5, "raw_bytes": raw_bytes,
            "write_s": write_s, "steps": out}


def _model_file(root, kind):
    from shifu_tpu_torch.models.spec import load_model
    return load_model(os.path.join(root, "models", f"model0.{kind}"))


def auc(y, s):
    """Mann-Whitney AUC with average ranks for ties."""
    order = np.argsort(s, kind="mergesort")
    _, first, counts = np.unique(s[order], return_index=True,
                                 return_counts=True)
    ranks = np.empty(len(s))
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    pos = y > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def train_metrics(root, x, y):
    """Train log-loss and AUC of a saved GBT scored on the CPU."""
    import torch
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.models import gbdt
    kind, meta, params = _model_file(root, "gbt")
    ens = weights.to_torch(kind, meta, params, "cpu")
    p = gbdt.predict(meta, ens, x, None).double().numpy()
    p = np.clip(p, 1e-7, 1 - 1e-7)
    loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    return loss, auc(y, p)


def phase_train_main_path(report, workdir, device="cuda", rows=TRAIN_ROWS):
    """`train` on the card and on the CPU for RF, one-round squared GBT
    and log-loss GBT (and log-loss GBT through K4), then the port's
    `serve` on the card-trained model."""
    import torch
    sets = {
        "rf": ("RF", {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                      "FeatureSubsetStrategy": "SQRT"}, 0.0),
        "gbt_sq": ("GBT", {"TreeNum": 1, "MaxDepth": TRAIN_DEPTH,
                           "LearningRate": TRAIN_LR, "Loss": "squared"},
                   0.1),
        "gbt_log": ("GBT", {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                            "LearningRate": TRAIN_LR, "Loss": "log"}, 0.1),
    }
    # one raw table; the port's init → stats → norm on the card make
    # its ColumnConfig.json and CleanedData, which every set then trains
    # from (a copy a set, its train section rewritten)
    import shutil
    base = os.path.join(workdir, "base")
    write_model_set(base, "GBT", {}, 40, rows, 0.1)
    for step, line in run_pipeline(base, device).items():
        print(f"  {step} on {line['device']}: {json.dumps(line)}")
    keep = shutil.ignore_patterns("data")
    for name, (alg, params, vr) in sets.items():
        for where in ("card", "cpu"):
            d = os.path.join(workdir, f"{name}_{where}")
            shutil.copytree(base, d, ignore=keep)
            set_config(d, "train", algorithm=alg, params=params,
                       validSetRate=vr)
    fused_root = os.path.join(workdir, "gbt_log_fused")
    shutil.copytree(base, fused_root, ignore=keep)
    set_config(fused_root, "train", algorithm="GBT",
               params=sets["gbt_log"][1], validSetRate=0.1)
    clean = np.load(os.path.join(base, "tmp", "CleanedData", "data.npz"))
    data = {"gbt_log": (clean["dense"], clean["tags"])}

    # each `train` run reports its kernels' launches (its process's
    # counters start at zero and are read before and after the run);
    # the main path's counts are the card runs' sums
    # the CPU twins run on four threads beside the card runs
    def card_runs():
        out = {name: run_step(os.path.join(workdir, f"{name}_card"),
                              "train", device) for name in sets}
        out["gbt_log_fused"] = run_step(fused_root, "train", device,
                                        {"SHIFU_TPU_HIST_FUSED": "1"})
        return out

    def cpu_runs():
        return {name + "_cpu": run_step(os.path.join(workdir,
                                                     f"{name}_cpu"),
                                        "train", "cpu",
                                        CPU_TWIN_ENV)
                for name in sets}
    on_card, on_cpu = in_parallel(card_runs, cpu_runs)
    runs = {}
    for name in sets:
        runs[name] = on_card[name]
        runs[name + "_cpu"] = on_cpu[name + "_cpu"]
    runs["gbt_log_fused"] = on_card["gbt_log_fused"]
    launches = {k: sum(r["launches"][k] for n, r in runs.items()
                       if not n.endswith("_cpu"))
                for k in ("level_hist", "level_hist_fused", "best_splits")}
    for name, r in runs.items():
        print(f"  train {name}: {r['algorithm']} on {r['device']} in "
              f"{r['seconds']:.2f} s, launches {r['launches']}")
    for k, v in launches.items():
        assert v > 0, f"kernel {k} was not launched on the train path"
        report[k]["launches"] = v

    for name, kind in (("rf", "rf"), ("gbt_sq", "gbt")):
        _, meta_a, pa = _model_file(os.path.join(workdir, f"{name}_card"),
                                    kind)
        _, meta_b, pb = _model_file(os.path.join(workdir, f"{name}_cpu"),
                                    kind)
        assert meta_a == meta_b, f"{name}: meta differs"
        for part in ("trees", "tables"):
            for k in pb[part]:
                assert np.array_equal(pa[part][k], pb[part][k]), \
                    f"{name}: {part}.{k} differs between card and CPU"
        print(f"  {name}: card-trained file bit-exact with the CPU run")
    x, y = data["gbt_log"]
    ref = train_metrics(os.path.join(workdir, "gbt_log_cpu"), x, y)
    for name in ("gbt_log_card", "gbt_log_fused"):
        loss, a = train_metrics(os.path.join(workdir, name), x, y)
        assert abs(loss - ref[0]) <= 1e-4 * ref[0], \
            f"{name}: train log-loss {loss} vs CPU {ref[0]}"
        assert abs(a - ref[1]) <= 1e-3, f"{name}: AUC {a} vs CPU {ref[1]}"
        print(f"  {name}: train log-loss {loss:.6f} (CPU {ref[0]:.6f}), "
              f"AUC {a:.6f} (CPU {ref[1]:.6f}) ok")
    report["train_runs"] = runs

    # the port's serve scores the card-trained model, against the CPU
    from shifu_tpu_torch.serve.service import ScorerService
    models = os.path.join(workdir, "gbt_log_card", "models")
    rows_in = {"raw_dense": x[:512]}
    gpu = ScorerService(models_dir=models, max_delay=0.002, device=device)
    cpu = ScorerService(models_dir=models, max_delay=0.002, device="cpu")
    try:
        gpu.start(proto={"raw_dense": x[:1]})
        cpu.start(proto={"raw_dense": x[:1]})
        got, want = gpu.submit(**rows_in), cpu.submit(**rows_in)
    finally:
        gpu.close()
        cpu.close()
    for k in want:
        assert got[k].shape == (512,) and np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    print("  serve: the card-trained GBT scores 512 rows on the card like "
          "the CPU twin")
    if device == "cuda":
        torch.cuda.synchronize()


def _gbt_data(r, device, seed=50):
    """HIGGS-width training data made on the card: (C, R) raw values
    with NaN/±inf, their (C, R) int32 bins of 64 (missing included) and
    cuts, and labels from the raw values."""
    import torch
    vals, cuts, binsT, _, _, _ = hist_inputs(seed, r, 1, device, False)
    v = torch.nan_to_num(vals, nan=0.0, posinf=3.0, neginf=-3.0)
    logit = v[0] - 0.8 * v[1] + 0.5 * v[2] * v[3] + (v[4] > 0.5).float()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    y = (logit + torch.randn(r, generator=gen, device=device) > 0).float()
    del v, logit
    return vals, binsT, cuts, y


def profile_by_kernel(fn):
    """(wall ms, {category: device ms}) over `fn` under torch.profiler:
    level_hist, best_splits, and everything else the build launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats = {"level_hist": 0.0, "best_splits": 0.0, "other": 0.0}
    counts = {"level_hist": 0, "best_splits": 0, "other": 0}
    by_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = "level_hist" if "level_hist" in ev.name else \
            "best_splits" if "best_splits" in ev.name else "other"
        ms = ev.self_device_time_total / 1e3
        cats[key] += ms
        counts[key] += 1
        n, t = by_name.get(ev.name[:90], (0, 0.0))
        by_name[ev.name[:90]] = (n + 1, t + ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return wall_ms, cats, counts, [(k, n, t) for k, (n, t) in top]


def profile_levels(fn):
    """Per level of one tree built by `fn`, for the histograms
    (`_child_level_histograms`: K3 or K4 plus the sibling subtraction),
    the split search and fold (`_apply_level`: K5 plus the fold) and the
    routing step (`_route_level`): host ms (the range on the CPU),
    device span ms (first to last kernel of the range on the card's
    timeline, gaps included) and kernel ms (device time of the kernels
    and copies inside that span), from `torch.profiler` ranges put
    around those three builder functions for the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from shifu_tpu_torch.models import gbdt
    names = {"_child_level_histograms": "hist", "_apply_level": "split",
             "_route_level": "route"}
    saved = {k: getattr(gbdt, k) for k in names}

    def wrap(key, f):
        def inner(*a, **kw):
            with record_function("tree." + names[key]):
                return f(*a, **kw)
        return inner

    torch.cuda.synchronize()
    try:
        for k, f in saved.items():
            setattr(gbdt, k, wrap(k, f))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k, f in saved.items():
            setattr(gbdt, k, f)
    host = {v: [] for v in names.values()}
    spans = {v: [] for v in names.values()}
    kernels = []
    for ev in prof.events():
        t = ev.time_range
        if ev.name.startswith("tree."):
            side = spans if ev.device_type == DeviceType.CUDA else host
            side[ev.name[5:]].append((t.start, t.end))
        elif ev.device_type == DeviceType.CUDA:
            kernels.append((t.start, t.end))

    def busy(a, b):
        return sum(max(0, min(e, b) - max(s, a)) for s, e in kernels)

    rows = {}
    for key in names.values():
        h = sorted(host[key])
        g = sorted(spans[key])
        rows[key] = [{"host_ms": (he - hs) / 1e3,
                      "span_ms": (ge - gs) / 1e3 if i < len(g) else None,
                      "kernel_ms": busy(gs, ge) / 1e3 if i < len(g)
                      else None}
                     for i, ((hs, he), (gs, ge)) in enumerate(
                         zip(h, g + [(0, 0)] * (len(h) - len(g))))]
    return wall_ms, rows


def k3_cost(c, r_active, r, n_slots, n_bins, width=1):
    """Bytes: the bins (`width` bytes each: 1 for the builders' uint8,
    4 for int32) of rows in a live slot, slot/grad/hess of every row, G
    and H written once. Operations: one add each into G and H per live
    (row, column)."""
    return (width * c * r_active + 12 * r + 8 * n_slots * c * n_bins,
            2 * c * r_active)


def k4_cost(c, r_active, r, k, n_slots, n_bins):
    """K3's bytes with raw values in place of bins plus the cut table;
    operations add ⌈log2(K+1)⌉ compares per live cell for the bins."""
    return (4 * c * r_active + 4 * c * k + 12 * r
            + 8 * n_slots * c * n_bins,
            2 * c * r_active + c * r_active * math.ceil(math.log2(k + 1)))


def k5_cost(n, n_bins, mask):
    """What K5 needs of these inputs, node by node: G and H of column 0
    and of each column switched on, read once (a masked-off column
    other than 0 can never win); the mask's rows once; the six (N,)
    outputs (4 + 4 + 4 + 1 + 4 + 4 bytes a node). Operations: two
    cumsum adds and ~22 flops for the two gains per main bin of a column
    switched on; a masked-off column 0 needs only its sums and bin 0's
    gains (its totals and an all-masked node's default_left)."""
    rows = mask.reshape(-1, mask.shape[-1]) > 0
    per_row = n // rows.shape[0]
    on = int(rows.sum()) * per_row
    col0_off = int((~rows[:, 0]).sum()) * per_row
    bm = n_bins - 1
    return (8 * n_bins * (on + col0_off) + 4 * rows.numel() + 21 * n,
            24 * bm * on + (2 * bm + 22) * col0_off)


def launch_floor():
    """What a launch costs on this card: a one-element PyTorch
    elementwise op (`add_` of a scalar), its CUDA-event time a call and
    its kernel's device time from the profiler."""
    import torch
    x = torch.zeros(1, device="cuda")
    fn = lambda: x.add_(1.0)  # noqa: E731
    return {"name": "launch floor", "shape": "1 element add_",
            "ms": cuda_ms(fn, 1000),
            "kernel_device_ms": kernel_device_ms(fn, 1000,
                                                 "elementwise_kernel")}


# K5's timed shapes at the HIGGS widths, (N, mask rows): one tree's root
# ((C,) mask) and leaf level (the GBT builder's (1, C) mask, the
# kernels line's shape, and a mask a node), and a forest level of 10
# and of 20 trees ((T, C) masks)
K5_TIMED = ((1, None), (32, 1), (32, 32), (320, 10), (640, 20))


def k5_timing():
    """K5 at the builders' level shapes (C = 28, B = 64) by events and
    profiler, beside its plain version, its bound and the launch floor;
    its kernel time with 8, 16 and 32 warps a block, the evidence for
    `best_splits._warps`; and its kernel time under RF's SQRT feature
    subsets."""
    import torch
    from shifu_tpu_torch.ops import best_splits as bs
    rows = [launch_floor()]
    for n, m in K5_TIMED:
        g, h, mask = split_inputs(70 + n, n, "cuda", mask_rows=m)
        fn = lambda: bs.best_splits(g, h, mask, 1.0, 1.0)  # noqa: E731
        bnd, by = bound_ms(*k5_cost(n, GBT_BINS, mask))
        shape = f"N={n} C={GBT_COLS} B={GBT_BINS} mask {tuple(mask.shape)}"
        rows.append({"name": "best_splits", "shape": shape,
                     "ms": cuda_ms(fn, 200),
                     "kernel_device_ms": kernel_device_ms(
                         fn, 200, "best_splits_kernel"),
                     "plain_ms": cuda_ms(lambda: bs.best_splits_plain(
                         g, h, mask, 1.0, 1.0), 50),
                     "library_ms": None, "bound_ms": bnd, "bound_by": by})
        chosen = bs._warps
        try:
            for warps in (8, 16, 32):
                bs._warps = lambda n_, dev_, w=warps: w
                rows.append({"name": "best_splits warps", "shape": shape,
                             "warps": warps,
                             "kernel_device_ms": kernel_device_ms(
                                 fn, 200, "best_splits_kernel")})
        finally:
            bs._warps = chosen
    # RF's SQRT feature subsets: 5 of 28 columns on in each tree's row
    from shifu_tpu_torch.models import gbdt
    on = gbdt.feature_subset_count("SQRT", GBT_COLS)
    for n, m in K5_TIMED[1:]:
        if m == n:
            continue
        g, h, _ = split_inputs(70 + n, n, "cuda", mask_rows=m)
        gen = torch.Generator(device="cuda").manual_seed(5 + n)
        mask = torch.zeros((m, GBT_COLS), device="cuda")
        for i in range(m):
            mask[i, torch.randperm(GBT_COLS, generator=gen,
                                   device="cuda")[:on]] = 1.0
        bnd, by = bound_ms(*k5_cost(n, GBT_BINS, mask))
        rows.append({"name": "best_splits sqrt", "shape": f"N={n} C="
                     f"{GBT_COLS} B={GBT_BINS} mask {tuple(mask.shape)}, "
                     f"{on} columns on a row",
                     "kernel_device_ms": kernel_device_ms(
                         lambda: bs.best_splits(g, h, mask, 1.0, 1.0),  # noqa
                         200, "best_splits_kernel"),
                     "bound_ms": bnd, "bound_by": by})
    return rows


def kernels_between_markers(fn):
    """Names of the CUDA kernels `fn` launches, from `torch.profiler`:
    those between two marker kernels (`torch.cuda._sleep`'s spin
    kernel) on the card's timeline. Padding launches before and after
    keep the counted window away from the trace's ends, where the
    profiler may miss the records of a short window's kernels; a trace
    that lost a marker's record is taken again, up to six times (a
    process that has traced many earlier phases loses one more often)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad = torch.zeros(1, device="cuda")
    for attempt in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                pad.add_(1.0)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            for _ in range(100):
                pad.add_(1.0)
            torch.cuda.synchronize()
        evs = sorted((ev.time_range.start, ev.name) for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA)
        marks = [i for i, (_, name) in enumerate(evs)
                 if "spin_kernel" in name]
        if len(marks) == 2:
            return [name for _, name in evs[marks[0] + 1:marks[1]]]
        print(f"  (trace {attempt + 1}: {len(marks)} marker kernels among "
              f"{len(evs)} kernel records; taken again)")
    raise AssertionError(f"found {len(marks)} marker kernels")


def split_step_launches(cfg, t=20, p=32, seed=75):
    """CUDA kernels of one level's split step (`gbdt._apply_level` on a
    forest level of T trees × P nodes): the split search alone (the
    fold stubbed out), then the fold of what it found."""
    import torch
    from shifu_tpu_torch.models import gbdt
    g, h, _ = split_inputs(seed, t * p, "cuda", integer=False)
    g = g.reshape(t, p, GBT_COLS, GBT_BINS)
    h = h.reshape(t, p, GBT_COLS, GBT_BINS)
    masks = torch.ones((t, GBT_COLS), device="cuda")
    trees = gbdt._empty_trees(cfg, t, "cuda")
    depth = int(math.log2(p))
    fold, found = gbdt._fold_splits, {}
    gbdt._apply_level(cfg, trees, g, h, masks, depth)        # warm-up
    try:
        gbdt._fold_splits = lambda cfg_, trees_, s_, d_: found.update(s_)
        search = kernels_between_markers(
            lambda: gbdt._apply_level(cfg, trees, g, h, masks, depth))
    finally:
        gbdt._fold_splits = fold
    folded = kernels_between_markers(lambda: fold(cfg, trees, found, depth))
    return {what: {"launches": len(names),
                   "kernels": sorted({k[:60] for k in names})}
            for what, names in (("search", search), ("fold", folded))}


def level_slots(seed, r, n_slots, half, device):
    """(R,) slots of one level: every row live (the root), or, with
    `half`, the left children of S parents live (sibling subtraction:
    the right half of the rows carries -1)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randint(0, 2 * n_slots if half else n_slots, (r,),
                      generator=gen, device=device, dtype=torch.int32)
    return torch.where(u % 2 == 0, u // 2, -1) if half else u


def k3_sweeps(report, r=HIGGS_ROWS):
    """K3 on uint8 bins at R = 2M: over one tree's levels (returns the sum
    of their times), on skewed bins, and under forced plan variants."""
    import torch
    from shifu_tpu_torch.ops import level_hist as lh
    vals, cuts, binsT, _, grad, hess = hist_inputs(80, r, 1, "cuda", False)
    del vals, cuts
    bins8 = binsT.to(torch.uint8)
    del binsT
    gen = torch.Generator(device="cuda").manual_seed(81)
    skew = torch.where(torch.rand(bins8.shape, generator=gen,
                                  device="cuda") < 0.9,
                       torch.zeros_like(bins8), bins8)
    out = {"levels": [], "variants": []}
    # one tree's levels: the root (every row live), then S = 1 … 32
    total = 0.0
    for depth, (s, half) in enumerate([(1, False)] + [
            (2 ** d, True) for d in range(6)]):
        slot = level_slots(90 + depth, r, s, half, "cuda").to(torch.int32)
        live = int(((slot >= 0) & (slot < s)).sum())
        fn = lambda: lh.level_histograms(bins8, slot, grad, hess, s,  # noqa
                                         GBT_BINS)
        ms = cuda_ms(fn, 20)
        total += ms
        bnd, by = bound_ms(*k3_cost(GBT_COLS, live, r, s, GBT_BINS, 1))
        out["levels"].append({"depth": depth, "S": s, "live_rows": live,
                              "ms": ms, "bound_ms": bnd, "bound_by": by,
                              "plan": lh.plan_for(bins8, None, slot, s,
                                                  GBT_BINS)._asdict()})
    # uniform and skewed bins under the chosen plan and forced variants
    for s in (1, 32):
        slot = level_slots(95 + s, r, s, False, "cuda").to(torch.int32)
        variants = [("plan", {})] + [
            (f"copies {cp}", {"copies": cp}) for cp in (1, 2, 4, 8)] + [
            (f"cluster {cl}", {"cluster": cl}) for cl in (1, 2, 4, 7)]
        for name, force in variants:
            try:
                v = lh.plan_for(bins8, None, slot, s, GBT_BINS, **force)
            except ValueError:      # not even one slot fits beside them
                continue
            row = {"S": s, "variant": name, "plan": v._asdict()}
            for bins_name, b in (("uniform", bins8), ("skewed", skew)):
                row[bins_name + "_ms"] = cuda_ms(
                    lambda: lh._launch(b, None, slot, grad, hess, s,  # noqa
                                       GBT_BINS, plan=v), 20)
            out["variants"].append(row)
    for row in out["levels"] + out["variants"]:
        print("  k3 " + json.dumps(row))
    out["levels_sum_ms"] = total
    report["k3_sweeps"] = out
    return total


def phase_train_timing(report, t_start):
    """HIGGS widths (28 columns, depth 6, 64 bins, log loss, lr 0.2):
    per-kernel times at the main path's shapes, the end-to-end build at
    2M rows × 10 trees, one profiled tree, and 11M × 20 if the time
    limit allows."""
    import torch
    from shifu_tpu_torch.models import gbdt
    from shifu_tpu_torch.ops import best_splits as bs
    from shifu_tpu_torch.ops import level_hist as lh
    sweep = []
    r = HIGGS_ROWS
    for s in HIST_SLOTS:
        vals, cuts, binsT, slot, grad, hess = hist_inputs(60 + s, r, s,
                                                          "cuda", False)
        live = (slot >= 0) & (slot < s)
        r_active = int(live.sum())
        # the library call: bincount over the flat (slot, column, bin)
        # index with a trailing dump slot, once for G and once for H
        slot_d = torch.where(live, slot, s).long()
        flat = ((slot_d * GBT_COLS)[None, :]
                + torch.arange(GBT_COLS, device="cuda")[:, None]) \
            * GBT_BINS + binsT.long()
        flat = flat.reshape(-1)
        wg = grad.expand(GBT_COLS, r).reshape(-1)
        wh = hess.expand(GBT_COLS, r).reshape(-1)
        size = (s + 1) * GBT_COLS * GBT_BINS
        lib = cuda_ms(lambda: (torch.bincount(flat, weights=wg,
                                              minlength=size),
                               torch.bincount(flat, weights=wh,
                                              minlength=size)), 10)
        del flat, wg, wh
        bins8 = binsT.to(torch.uint8)
        for name, fn, plain, cost in (
                ("level_hist",
                 lambda: lh.level_histograms(bins8, slot, grad, hess, s,
                                             GBT_BINS),
                 lambda: lh.level_histograms_plain(bins8, slot, grad, hess,
                                                   s, GBT_BINS),
                 k3_cost(GBT_COLS, r_active, r, s, GBT_BINS, 1)),
                ("level_hist int32",
                 lambda: lh.level_histograms(binsT, slot, grad, hess, s,
                                             GBT_BINS),
                 lambda: lh.level_histograms_plain(binsT, slot, grad, hess,
                                                   s, GBT_BINS),
                 k3_cost(GBT_COLS, r_active, r, s, GBT_BINS, 4)),
                ("level_hist_fused",
                 lambda: lh.level_histograms_fused(vals, cuts, slot, grad,
                                                   hess, s, GBT_BINS),
                 lambda: lh.level_histograms_plain(
                     lh.bins_from_values_plain(vals, cuts, GBT_BINS), slot,
                     grad, hess, s, GBT_BINS),
                 k4_cost(GBT_COLS, r_active, r, cuts.shape[1], s,
                         GBT_BINS))):
            ms = cuda_ms(fn, 20)
            dev = kernel_device_ms(fn, 20, "level_hist_kernel")
            pl_ms = cuda_ms(plain, 5, warmup=1)
            bnd, by = bound_ms(*cost)
            sweep.append({"name": name, "shape": f"R={r}x{GBT_COLS} S={s} "
                          f"B={GBT_BINS}", "ms": ms, "kernel_device_ms": dev,
                          "plain_ms": pl_ms,
                          "library_ms": lib if name.startswith("level_hist ")
                          or name == "level_hist" else None,
                          "bound_ms": bnd, "bound_by": by})
        del vals, cuts, binsT, bins8, slot, grad, hess
    sweep += k5_timing()
    for row in sweep:
        print("  timing " + json.dumps(row))
    # the kernels line: K3 (on the builders' uint8 bins) and K4 at the
    # leaf level (S = 32), K5 at the GBT leaf level (N = 32, one mask)
    for row in sweep:
        if (row["name"] in ("level_hist", "level_hist_fused")
                and "S=32" in row["shape"]) \
                or (row["name"] == "best_splits"
                    and row["shape"].startswith("N=32 ")
                    and row["shape"].endswith(f"mask (1, {GBT_COLS})")):
            report[row["name"]].update({k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    report["train_sweep"] = sweep
    levels = k3_sweeps(report)

    cfg = gbdt.TreeConfig(max_depth=TRAIN_DEPTH, n_bins=GBT_BINS,
                          learning_rate=TRAIN_LR, loss="log")
    e2e = {}
    vals, binsT, cuts, y = _gbt_data(r, "cuda")
    w = torch.ones_like(y)
    walls = {}
    for route, bins in (("binned", binsT),
                        ("fused", gbdt.FusedBins(vals, cuts))):
        gbdt.build_gbt(cfg, bins, y, w, 1)                  # warm-up
        counts0 = (lh.launches, lh.fused_launches, bs.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trees, _ = gbdt.build_gbt(cfg, bins, y, w, HIGGS_TREES)
        walls[route] = wall = time.perf_counter() - t0
        assert np.isfinite(trees["leaf_value"]).all()
        per_tree = {"level_hist": (lh.launches - counts0[0]) / HIGGS_TREES,
                    "level_hist_fused": (lh.fused_launches - counts0[1])
                    / HIGGS_TREES,
                    "best_splits": (bs.launches - counts0[2]) / HIGGS_TREES}
        wall_ms, cats, counts, top = profile_by_kernel(
            lambda: gbdt.build_gbt(cfg, bins, y, w, 1))
        busy = sum(cats.values())
        e2e[f"{route} {r}x{HIGGS_TREES}"] = {
            "wall_s": wall, "row_trees_per_s": r * HIGGS_TREES / wall,
            "launches_per_tree": per_tree,
            "profiled_tree": {"wall_ms": wall_ms, "device_ms": cats,
                              "device_launches": counts,
                              "idle_share": 1.0 - busy / wall_ms,
                              "top_kernels": top}}
        print(f"  train {route} {r} rows x {HIGGS_TREES} trees: "
              f"{wall:.3f} s")
    tree_k3 = e2e[f"binned {r}x{HIGGS_TREES}"]["profiled_tree"][
        "device_ms"]["level_hist"]
    print(f"  K3 over one tree's levels: sweep sum {levels:.4f} ms (random "
          f"slots), profiled tree {tree_k3:.4f} ms (its own rows)")
    report["k3_sweeps"]["tree_profile_k3_ms"] = tree_k3
    wall_ms, per_level = profile_levels(
        lambda: gbdt.build_gbt(cfg, binsT, y, w, 1))
    e2e[f"binned {r}x{HIGGS_TREES}"]["per_level"] = {
        "wall_ms": wall_ms, "host_device_ms": per_level}
    print("  per level of one profiled tree: " + json.dumps(per_level))
    step = split_step_launches(cfg)
    step["split_host_ms_per_level"] = [
        row["host_ms"] for row in per_level["split"]]
    e2e[f"binned {r}x{HIGGS_TREES}"]["split_step"] = step
    print("  split step a level (launches; host ms per level): "
          + json.dumps(step))
    del vals, binsT, cuts, y, w
    wall = walls["binned"]
    elapsed = time.monotonic() - t_start
    projected = wall * (BIG_ROWS / r) * (BIG_TREES / HIGGS_TREES) * 1.5 + 30
    if elapsed + projected < LIMIT_S / 2:
        vals, binsT, _, y = _gbt_data(BIG_ROWS, "cuda")
        del vals
        w = torch.ones_like(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gbdt.build_gbt(cfg, binsT, y, w, BIG_TREES)
        big = time.perf_counter() - t0
        e2e[f"binned {BIG_ROWS}x{BIG_TREES}"] = {
            "wall_s": big, "row_trees_per_s": BIG_ROWS * BIG_TREES / big}
        print(f"  train {BIG_ROWS} rows x {BIG_TREES} trees: {big:.3f} s")
        del binsT, y, w
    else:
        print(f"  train {BIG_ROWS} x {BIG_TREES}: skipped (projected "
              f"{projected:.0f} s after {elapsed:.0f} s)")
    print("  train end to end: " + json.dumps(e2e))
    report["train_e2e"] = e2e


def serve_walls(sizes=(1, 8, 64, 512), device="cuda", turns=2,
                requests=STREAM // 2):
    """Closed-loop request latency of both services on the card (one
    client, `requests` requests a turn and size): p50, p99 and the mean
    device stage in ms, a row per service, mode and size with one entry
    a turn. Where `ScorerService` takes `graphs`, the graph service and
    its eager twin (graphs=False) run in turns, each size in turn;
    otherwise only the service as it is (mode "eager"). It calls only
    `ScorerService`, so it times another tree of the package as well:
    `python3 chip_smoke.py --serve-walls` from a copy of that tree with
    this script in its root."""
    import inspect

    from shifu_tpu_torch.serve.service import ScorerService
    rng = np.random.default_rng(42)
    modes = (("graphs", {"graphs": True}), ("eager", {"graphs": False})) \
        if "graphs" in inspect.signature(ScorerService).parameters \
        else (("eager", {}),)
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        nn_dir, tree_dir, norm, nn_rows, tree_req = serving_sets(workdir,
                                                                 rng)
        for name, kw, make in (("nn+norm", {"models_dir": nn_dir,
                                            "norm": norm}, nn_rows),
                               ("gbt+rf", {"models_dir": tree_dir},
                                tree_req)):
            proto = make(rng, 1)
            svcs = {}
            try:
                for mode, mkw in modes:
                    svcs[mode] = ScorerService(max_delay=0.002,
                                               device=device, **kw, **mkw)
                    svcs[mode].start(proto=proto)
                for n in sizes:
                    rows = [make(rng, n) for _ in range(8)]
                    for _ in range(turns):
                        for mode, svc in svcs.items():
                            lat, dev = [], []
                            for i in range(requests):
                                _, timing = svc.submit_timed(
                                    **rows[i % len(rows)])
                                lat.append(timing["total_s"] * 1e3)
                                dev.append(timing["device_s"] * 1e3)
                            out.setdefault(f"{name} {mode} {n}", []).append(
                                {"p50_ms": float(np.percentile(lat, 50)),
                                 "p99_ms": float(np.percentile(lat, 99)),
                                 "device_ms": float(np.mean(dev))})
            finally:
                for svc in svcs.values():
                    svc.close()
    return out


def serve_wall_pairs(parent, pairs, sizes=(1, 512)):
    """`--serve-walls` at `sizes` in `pairs` process pairs, the tree at
    `parent` (this script copied into its root) against this one, in
    turns (parent, this, this, parent, ...) on one card, with the tracer
    off. Per tree and (service, mode, size): each process's p50 and p99
    (the mean of its turns), and their min, median and max over the
    processes."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    shutil.copy(os.path.abspath(__file__), os.path.join(parent,
                                                        "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIFU_TPU_TRACE")}
    raw = {"parent": [], "this": []}
    for i in range(pairs):
        order = (("parent", parent), ("this", here))
        for tag, tree in (order if i % 2 == 0 else order[::-1]):
            proc = subprocess.run(
                [sys.executable, "chip_smoke.py", "--serve-walls",
                 ",".join(str(n) for n in sizes)], cwd=tree, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, timeout=600)
            assert proc.returncode == 0, (tag, proc.returncode)
            raw[tag].append(json.loads(
                proc.stdout.strip().splitlines()[-1])["serve_walls_ms"])
    out = {}
    for tag, runs in raw.items():
        for key in runs[0]:
            for q in ("p50_ms", "p99_ms"):
                vals = sorted(float(np.mean([t[q] for t in run[key]]))
                              for run in runs)
                out.setdefault(f"{key} {q}", {})[tag] = {
                    "min": vals[0], "median": float(np.median(vals)),
                    "max": vals[-1], "each": vals}
    for key, row in out.items():
        print(f"  {key}: parent {row['parent']['min']:.4f} / "
              f"{row['parent']['median']:.4f} / {row['parent']['max']:.4f},"
              f" this {row['this']['min']:.4f} / {row['this']['median']:.4f}"
              f" / {row['this']['max']:.4f} (min / median / max)")
    return out


def train_walls(repeats=3):
    """Wall seconds of `build_gbt` at 2M rows × 10 trees (HIGGS widths),
    binned and fused, `repeats` times each after a one-tree warm-up, and
    the host ms of each level's split step (`_apply_level`) in one
    profiled binned tree (`profile_levels`). It calls only `build_gbt`
    and the builder functions `profile_levels` wraps, so it times
    another tree of the package as well: `python3 chip_smoke.py
    --train-walls` from a copy of that tree with this script in its
    root."""
    import torch
    from shifu_tpu_torch.models import gbdt
    cfg = gbdt.TreeConfig(max_depth=TRAIN_DEPTH, n_bins=GBT_BINS,
                          learning_rate=TRAIN_LR, loss="log")
    vals, binsT, cuts, y = _gbt_data(HIGGS_ROWS, "cuda")
    w = torch.ones_like(y)
    walls = {}
    for route, bins in (("binned", binsT),
                        ("fused", gbdt.FusedBins(vals, cuts))):
        gbdt.build_gbt(cfg, bins, y, w, 1)
        walls[route] = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gbdt.build_gbt(cfg, bins, y, w, HIGGS_TREES)
            walls[route].append(time.perf_counter() - t0)
    _, per_level = profile_levels(lambda: gbdt.build_gbt(cfg, binsT, y, w,
                                                         1))
    return walls, [row["host_ms"] for row in per_level["split"]]


# ---------------------------------------------------------------------------
# The scoring slice: posttrain and eval, card against CPU
# ---------------------------------------------------------------------------

EVAL_ROWS = 262_144         # phase 8's holdout set
NN_EVAL_ROWS = 65_536       # the NN table of --eval-walls/--varselect-walls
MAIN_NN_ROWS = 16_384       # phase 11's raw table in the main run (cut
#                             from NN_EVAL_ROWS, then from 32,768, for
#                             the run's time limit)
NN_POST_CPU_ROWS = 4_096    # phase 11's posttrain held against the CPU
AUCS = ("areaUnderRoc", "weightedAreaUnderRoc", "areaUnderPr")


def add_eval_set(root, name, data_dir):
    """Register `data_dir` (a part file and its `.pig_header`) as eval
    set `name` of the model set, its dataSet otherwise the model's."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        d = json.load(f)
    ds = dict(d["dataSet"], dataPath=data_dir,
              headerPath=os.path.join(data_dir, ".pig_header"))
    d["evals"] = [e for e in d.get("evals") or [] if e["name"] != name] \
        + [{"name": name, "dataSet": ds}]
    ModelConfig.from_dict(d).save(root)


def _digit(token):
    """One unit in the last printed digit of a %.6f / %.6g token."""
    mant, _, exp = token.lower().partition("e")
    dec = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - dec)


def _within(x, y, lim, share=0.0):
    """0 when `x` and `y` are within `lim`, 1 when only within `share`
    more (one row's share at a tie edge); raises otherwise."""
    if x == y or (math.isnan(x) and math.isnan(y)):
        return 0
    if abs(x - y) <= lim * (1 + 1e-9):
        return 0
    if abs(x - y) <= lim + share * (1 + 1e-6):
        return 1
    raise AssertionError(f"{x!r} vs {y!r} (tolerance {lim}, one row "
                         f"{share})")


def _close(a, b, tol, share=0.0):
    """`_within` for two printed numbers, whose tolerance is at least a
    unit of their last printed digit."""
    return _within(float(a), float(b), max(tol, _digit(a), _digit(b)),
                   share)


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def score_counts(path):
    """(n_pos, n_neg, weighted pos, weighted neg, max weight) of an
    EvalScore.csv: what one row can move a bucket field by."""
    head = _lines(path)[0].split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    tag, w = data[:, head.index("tag")], data[:, head.index("weight")]
    pos = tag > 0.5
    return (int(pos.sum()), int((~pos).sum()), float(w[pos].sum()),
            float(w[~pos].sum()), float(w.max()))


def _row_share(field, row, depth, counts):
    n_pos, n_neg, w_pos, w_neg, w_max = counts
    rec, wrec = 1.0 / max(n_pos, 1), w_max / max(w_pos, 1e-12)
    if field == "weightedPrecision":
        top = row["weightedRecall"] * w_pos / max(row[field], 1e-12)
        return w_max / top if top > 0 else 1.0
    return {"recall": rec, "weightedRecall": wrec,
            "fpr": 1.0 / max(n_neg, 1), "weightedFpr": w_max / max(w_neg,
                                                                     1e-12),
            "precision": 1.0 / max(depth * (n_pos + n_neg), 1.0),
            "liftUnit": rec / depth, "liftWeight": wrec / depth,
            }.get(field, 0.0)


def auc_allowance(scores, tags, weights, delta, beta):
    """The AUC analogue of the bucket fields' "one row's share": the
    share of (positive, negative) pairs whose order or tie two score
    vectors at most `delta` apart can swap, read from the reference's
    `scores`. A pair can change only when its two reference scores lie
    within 2·delta + beta (`beta` the width of one streaming
    `ScoreHistogram` bucket, 0 for the resident eval). Returns
    (unweighted share: pairs over n_pos·n_neg, weighted share: Σ w_p·w_n
    over W_pos·W_neg), by one sort and `np.searchsorted`."""
    scores = np.asarray(scores, np.float64)
    weights = np.asarray(weights, np.float64)
    pos = np.asarray(tags) > 0.5
    sp, wp = scores[pos], weights[pos]
    order = np.argsort(scores[~pos], kind="stable")
    sn, wn = scores[~pos][order], weights[~pos][order]
    if not sp.size or not sn.size:
        return 0.0, 0.0
    reach = 2.0 * delta + beta
    lo = np.searchsorted(sn, sp - reach, side="left")
    hi = np.searchsorted(sn, sp + reach, side="right")
    cum = np.concatenate(([0.0], np.cumsum(wn)))
    pairs = float((hi - lo).sum()) / (sp.size * sn.size)
    w_pairs = float((wp * (cum[hi] - cum[lo])).sum()) / \
        max(wp.sum() * wn.sum(), 1e-300)
    return pairs, w_pairs


def perf_allowance(ref_score_csv, ref_perf, delta, column="mean"):
    """{AUC key: allowance} for `compare_perf` from the reference's
    EvalScore.csv (`column`, the selector's score) and
    EvalPerformance.json: `delta` is the largest score difference
    `compare_score_csv` found, widened by one unit of the printed digit
    (the file rounds both sides); a streaming eval adds one bucket of its
    `ScoreHistogram`."""
    head = _lines(ref_score_csv)[0].split(",")
    data = np.loadtxt(ref_score_csv, delimiter=",", skiprows=1, ndmin=2)
    beta = 0.0
    if "streaming" in ref_perf:
        st = ref_perf["scoreStatus"]
        beta = (st["maxScore"] - st["minScore"]) / \
            ref_perf["streaming"]["scoreQuantBuckets"]
    unit, weighted = auc_allowance(
        data[:, head.index(column)], data[:, head.index("tag")],
        data[:, head.index("weight")], delta + 1e-6, beta)
    return {"areaUnderRoc": unit, "areaUnderPr": unit,
            "weightedAreaUnderRoc": weighted}


def compare_perf(a, b, tol, counts, score_scale, auc_tol=None,
                 allowance=None):
    """EvalPerformance dicts: each AUC within `auc_tol` (default `tol`)
    plus its `allowance` (the share of pairs the scores' own differences
    can reorder, `perf_allowance`; none by default); every bucket field
    within `tol` (binLowestScore within tol·scoreScale) or one row's
    share; scoreStatus equal but for max/min score (within `tol`).
    Returns (largest AUC difference, fields off by one row)."""
    auc_tol = tol if auc_tol is None else auc_tol
    allowance = allowance or {}
    auc_err = max(abs(a[k] - b[k]) for k in AUCS)
    assert all(abs(a[k] - b[k]) <= auc_tol + allowance.get(k, 0.0)
               for k in AUCS), [(k, a[k], b[k], auc_tol,
                                 allowance.get(k, 0.0)) for k in AUCS]
    edges = 0
    for curve in ("pr", "roc", "gains"):
        assert len(a[curve]) == len(b[curve]), curve
        for i, (ra, rb) in enumerate(zip(a[curve], b[curve])):
            depth = b["gains"][i]["actionRate"]
            for k, v in rb.items():
                lim = tol * (score_scale if k == "binLowestScore" else 1.0)
                edges += _within(ra[k], v, lim,
                                 _row_share(k, rb, depth, counts))
    if "scoreStatus" in b:
        sa, sb = a["scoreStatus"], b["scoreStatus"]
        for k in sb:
            if k in ("maxScore", "minScore"):
                assert abs(sa[k] - sb[k]) <= tol, (k, sa[k], sb[k])
            else:
                assert sa[k] == sb[k], (k, sa[k], sb[k])
    return auc_err, edges


def compare_score_csv(a_path, b_path, tol):
    """EvalScore.csv: header, tag and weight columns identical text, the
    score columns within `tol`. Returns the largest score difference."""
    la, lb = _lines(a_path), _lines(b_path)
    assert la[0] == lb[0], (la[0], lb[0])
    assert len(la) == len(lb), (len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        assert ra.split(",", 2)[:2] == rb.split(",", 2)[:2], (ra, rb)
    if len(la) == 1:
        return 0.0
    xa = np.loadtxt(a_path, delimiter=",", skiprows=1, ndmin=2)[:, 2:]
    xb = np.loadtxt(b_path, delimiter=",", skiprows=1, ndmin=2)[:, 2:]
    err = float(np.max(np.abs(xa - xb)))
    assert err <= tol + 1e-6 * (1 + 1e-6), f"EvalScore.csv: {err}"
    return err


def compare_confusion(a_path, b_path, tol, counts):
    """EvalConfusionMatrix.csv: thresholds within `tol`, counts equal,
    weighted counts within `tol` relative — or one row apart (1 and
    the largest weight) at a tie edge. Returns the fields off by a
    row."""
    la, lb = _lines(a_path), _lines(b_path)
    assert la[0] == lb[0] and len(la) == len(lb), (len(la), len(lb))
    edges = 0
    for ra, rb in zip(la[1:], lb[1:]):
        for j, (x, y) in enumerate(zip(ra.split(","), rb.split(","))):
            if j == 0:
                edges += _close(x, y, tol)
            elif j <= 4:
                edges += _close(x, y, 0.0, 1.0)
            else:
                edges += _close(x, y, tol * abs(float(y)), counts[4])
    return edges


def compare_gain_csv(a_path, b_path, tol, counts, score_scale):
    la, lb = _lines(a_path), _lines(b_path)
    assert la[0] == lb[0] and len(la) == len(lb)
    names = lb[0].split(",")
    edges = 0
    for ra, rb in zip(la[1:], lb[1:]):
        row = dict(zip(names, map(float, rb.split(","))))
        for k, x, y in zip(names, ra.split(","), rb.split(",")):
            lim = tol * (score_scale if k == "binLowestScore" else 1.0)
            edges += _close(x, y, lim, _row_share(k, row, row["actionRate"],
                                                  counts))
    return edges


def compare_eval_dir(a_root, b_root, name, tol, score_scale=1000.0,
                     files=("score", "perf", "confusion", "gain"),
                     auc_tol=None, reorder=False):
    """One eval set's outputs under ``evals/<name>/`` of two model sets
    (`b_root` the reference): EvalScore.csv, EvalPerformance.json,
    EvalConfusionMatrix.csv, gainchart.csv; the AUCs within `auc_tol`
    (default `tol`), plus, with `reorder`, the allowance of the pairs the
    scores' differences can reorder (`perf_allowance`). Returns the
    largest score and AUC differences, the AUC allowance and the bucket
    fields off by one row."""
    da = os.path.join(a_root, "evals", name)
    db = os.path.join(b_root, "evals", name)
    counts = score_counts(os.path.join(db, "EvalScore.csv"))
    out = {"score_err": compare_score_csv(
        os.path.join(da, "EvalScore.csv"), os.path.join(db, "EvalScore.csv"),
        tol)}
    edges = 0
    if "perf" in files:
        with open(os.path.join(da, "EvalPerformance.json")) as f:
            pa = json.load(f)
        with open(os.path.join(db, "EvalPerformance.json")) as f:
            pb = json.load(f)
        allow = perf_allowance(os.path.join(db, "EvalScore.csv"), pb,
                               out["score_err"]) if reorder else {}
        out["auc_allowance"] = max(allow.values(), default=0.0)
        out["auc_err"], e = compare_perf(pa, pb, tol, counts, score_scale,
                                         auc_tol=auc_tol, allowance=allow)
        out["auc"] = pb["areaUnderRoc"]
        edges += e
    if "confusion" in files:
        edges += compare_confusion(
            os.path.join(da, "EvalConfusionMatrix.csv"),
            os.path.join(db, "EvalConfusionMatrix.csv"), tol, counts)
    if "gain" in files:
        edges += compare_gain_csv(os.path.join(da, "gainchart.csv"),
                                  os.path.join(db, "gainchart.csv"), tol,
                                  counts, score_scale)
    out["tie_edges"] = edges
    return out


def compare_multiclass_eval(a_root, b_root, name, tol, rows=1):
    """A multi-class eval set's outputs of two model sets (`b_root` the
    reference): EvalScore.csv (header, tag and weight text identical,
    class scores within `tol`, the predicted class the same on all but
    `rows` rows), the weighted C×C EvalConfusionMatrix.csv (labels
    equal, each cell within the weight of the rows whose prediction
    moved, at most `rows` rows: one row's share each) and
    EvalPerformance.json (records and classes equal, accuracy and the
    per-class fields within those rows' share). Returns the largest
    score difference, the rows whose prediction moved and the
    accuracy."""
    da = os.path.join(a_root, "evals", name)
    db = os.path.join(b_root, "evals", name)
    sa, sb = (os.path.join(d, "EvalScore.csv") for d in (da, db))
    la, lb = _lines(sa), _lines(sb)
    assert la[0] == lb[0] and la[0].endswith(",predicted"), (la[0], lb[0])
    assert len(la) == len(lb), (len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        assert ra.split(",", 2)[:2] == rb.split(",", 2)[:2], (ra, rb)
    xa = np.loadtxt(sa, delimiter=",", skiprows=1, ndmin=2)
    xb = np.loadtxt(sb, delimiter=",", skiprows=1, ndmin=2)
    err = float(np.max(np.abs(xa[:, 2:-1] - xb[:, 2:-1]))) if len(xa) \
        else 0.0
    assert err <= tol + 1e-6 * (1 + 1e-6), f"EvalScore.csv: {err}"
    moved = xa[:, -1] != xb[:, -1]
    assert int(moved.sum()) <= rows, f"{int(moved.sum())} predictions moved"
    share = float(xb[moved, 1].sum())
    ca, cb = (_lines(os.path.join(d, "EvalConfusionMatrix.csv"))
              for d in (da, db))
    assert len(ca) == len(cb) and ca[0] == cb[0], (ca[0], cb[0])
    for ra, rb in zip(ca[1:], cb[1:]):
        fa, fb = ra.split(","), rb.split(",")
        assert fa[0] == fb[0], (ra, rb)
        for a, b in zip(fa[1:], fb[1:]):
            _close(a, b, 1e-6 * abs(float(b)), share)
    with open(os.path.join(da, "EvalPerformance.json")) as f:
        pa = json.load(f)
    with open(os.path.join(db, "EvalPerformance.json")) as f:
        pb = json.load(f)
    assert (pa["records"], pa["classes"]) == (pb["records"], pb["classes"])
    total = float(xb[:, 1].sum())
    _within(pa["accuracy"], pb["accuracy"], 1e-6, share / max(total, 1e-12))
    for qa, qb in zip(pa["perClass"], pb["perClass"]):
        assert qa["tag"] == qb["tag"], (qa, qb)
        _within(qa["support"], qb["support"], 1e-6 * qb["support"])
        # a moved row shifts its weight between a row and a column of
        # the matrix: precision, recall and f1 by at most twice that
        # weight over the smaller of the two sums
        tp = qb["recall"] * qb["support"]
        col = tp / qb["precision"] if qb["precision"] > 0 else qb["support"]
        lim = 2 * share / max(min(qb["support"], col), 1e-12)
        for k in ("precision", "recall", "f1"):
            _within(qa[k], qb[k], 1e-6, lim)
    return {"score_err": err, "moved_rows": int(moved.sum()),
            "accuracy": pb["accuracy"]}


def compare_eval_norm(a_path, b_path, tol):
    """EvalNorm.csv: header, tag and weight identical text, the values
    within `tol`. Returns the largest difference."""
    la, lb = _lines(a_path), _lines(b_path)
    assert la[0] == lb[0] and len(la) == len(lb), (len(la), len(lb))
    for ra, rb in zip(la[1:], lb[1:]):
        assert ra.split(",", 2)[:2] == rb.split(",", 2)[:2], (ra, rb)
    if len(la) == 1:
        return 0.0
    xa = np.loadtxt(a_path, delimiter=",", skiprows=1, ndmin=2)
    xb = np.loadtxt(b_path, delimiter=",", skiprows=1, ndmin=2)
    err = float(np.max(np.abs(xa - xb)))
    assert err <= tol + 1e-6 * (1 + 1e-6), f"EvalNorm.csv: {err}"
    return err


def compare_audit(a_path, b_path, tol):
    """The audit file line for line: every field identical text but the
    scores (the trailing model or class columns and finalScore), within
    `tol`."""
    la, lb = _lines(a_path), _lines(b_path)
    assert la[0] == lb[0] and len(la) == len(lb), (len(la), len(lb))
    head = lb[0].split("|")
    n_score = sum(1 for h in head if h.startswith(("model", "class"))) + 1
    for ra, rb in zip(la[1:], lb[1:]):
        fa, fb = ra.split("|"), rb.split("|")
        assert fa[:-n_score] == fb[:-n_score], (ra, rb)
        for x, y in zip(fa[-n_score:], fb[-n_score:]):
            _close(x, y, tol)
    return len(lb) - 1


def compare_posttrain(a_root, b_root, imp_rtol, bin_rtol):
    """featureimportance.csv (the same columns; values equal, or within
    `imp_rtol` relative) and ColumnConfig.json (binAvgScore within
    `bin_rtol` relative, every other field equal). Returns the largest
    relative differences."""
    def importance(root):
        rows = _lines(os.path.join(root, "featureimportance.csv"))
        assert rows[0] == "column,importance"
        return {r.split(",")[0]: float(r.split(",")[1]) for r in rows[1:]}
    ia, ib = importance(a_root), importance(b_root)
    assert set(ia) == set(ib), (set(ia) ^ set(ib))
    imp = max(abs(ia[k] - v) / max(abs(v), 1e-30) for k, v in ib.items())
    assert imp <= imp_rtol, f"featureimportance.csv: {imp}"
    with open(os.path.join(a_root, "ColumnConfig.json")) as f:
        ca = json.load(f)
    with open(os.path.join(b_root, "ColumnConfig.json")) as f:
        cb = json.load(f)
    worst = 0.0
    for x, y in zip(ca, cb):
        xa = x["columnBinning"].pop("binAvgScore", None)
        yb = y["columnBinning"].pop("binAvgScore", None)
        assert x == y, f"ColumnConfig {y['columnName']} moved"
        assert (xa is None) == (yb is None), y["columnName"]
        if yb is not None:
            va, vb = np.asarray(xa, float), np.asarray(yb, float)
            assert va.shape == vb.shape, y["columnName"]
            worst = max(worst, float(np.max(
                np.abs(va - vb) / np.maximum(np.abs(vb), 1e-30))))
    assert worst <= bin_rtol, f"binAvgScore: {worst}"
    return {"importance_rel": imp, "bin_avg_rel": worst}


def phase_posttrain_eval(report, workdir, device="cuda", rows=EVAL_ROWS):
    """Phase 8's second half: a holdout table from another seed is
    registered as eval set `holdout` of the card-trained RF and log-loss
    GBT sets; `posttrain` then `eval` run on the card and, on a copy of
    the set (the same model files), with `--device cpu`; on the GBT set
    also `eval -score`, `-confmat`, `-perf`, `-norm` and `-audit -n
    100`. Every output is held card against CPU. The two sets' chains,
    and then the split steps' three chains, run side by side."""
    import shutil
    holdout = os.path.join(workdir, "holdout")
    names, cols, _, _ = raw_table(np.random.default_rng(41), rows, False)
    write_raw(holdout, names, cols)

    def roots(name):
        return (os.path.join(workdir, f"{name}_card"),
                os.path.join(workdir, f"{name}_card_cpu"))

    def chain(name, verbs):
        """The twin runs of `verbs` in order; returns {step: lines}."""
        card, cpu = roots(name)
        out = {}
        for verb in verbs:
            key = f"{name} {verb if isinstance(verb, str) else ' '.join(verb)}"
            line_card, line_cpu = run_twins(card, cpu, verb, device)
            out[key] = {"card": line_card, "cpu": line_cpu}
        return out

    def set_chain(name):
        card, cpu = roots(name)
        out = chain(name, ("posttrain", "eval"))
        line = out[f"{name} eval"]["card"]
        assert line["rows"] == rows, line
        assert line["launches"]["fused_trees"] > 0, \
            f"{name}: eval on the card launched no fused_trees"
        errs = {**compare_posttrain(card, cpu, 0.0, 1e-6),
                **compare_eval_dir(card, cpu, "holdout", 1e-6)}
        return out, errs

    for name in ("rf", "gbt_log"):
        card, cpu = roots(name)
        add_eval_set(card, "holdout", holdout)
        shutil.copytree(card, cpu)
    runs, errs = {}, {}
    for name, (out, err) in zip(("rf", "gbt_log"), in_parallel(
            lambda: set_chain("rf"), lambda: set_chain("gbt_log"))):
        runs.update(out)
        errs[name] = err

    # the split steps and the exports, once, on the GBT set
    card, cpu = roots("gbt_log")
    for root in (card, cpu):
        shutil.rmtree(os.path.join(root, "evals"))
    for out in in_parallel(
            lambda: chain("gbt_log", (["eval", "-score"],
                                      ["eval", "-confmat"],
                                      ["eval", "-perf"])),
            lambda: chain("gbt_log", (["eval", "-norm"],)),
            lambda: chain("gbt_log", (["eval", "-audit", "-n", "100"],))):
        runs.update(out)
    for key, lines in runs.items():
        for where, line in lines.items():
            print(f"  {key}: {where} {json.dumps(line)}")
    split = compare_eval_dir(card, cpu, "holdout", 1e-6)
    split["norm_err"] = compare_eval_norm(
        os.path.join(card, "evals", "holdout", "EvalNorm.csv"),
        os.path.join(cpu, "evals", "holdout", "EvalNorm.csv"), 1e-6)
    audit = os.path.join("tmp", "smokeGBT_holdout_audit.data")
    split["audit_rows"] = compare_audit(os.path.join(card, audit),
                                        os.path.join(cpu, audit), 1e-6)
    assert split["audit_rows"] == 100, split
    errs["gbt_log split steps"] = split
    for name, err in errs.items():
        print(f"  {name}: card = CPU within 1e-6: {json.dumps(err)}")
    launches = sum(lines["card"]["launches"]["fused_trees"]
                   for lines in runs.values())
    report["fused_trees"]["launches"] += launches
    report["eval_trees"] = {"rows": rows, "runs": runs, "errors": errs}


def nn_raw_table(rng, rows, c=NN_IN):
    """`c` numeric columns and a label, 2 % of the values the missing
    token "?": values are multiples of 0.001 in [-9.999, 9.999], their
    text taken from a table, so 39M cells format in seconds. Returns
    (names, 2-D token array)."""
    x = np.clip(np.round(rng.normal(0, 1.5, (rows, c)) * 1000),
                -9999, 9999).astype(np.int32)
    logit = (x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2]) / 1500.0 \
        + rng.logistic(0, 1, rows)
    lut = np.array([f"{k / 1000:.3f}" for k in range(-9999, 10000)])
    tok = lut[x + 9999]
    tok[rng.random(tok.shape) < 0.02] = "?"
    label = np.where(logit > 0, "1", "0")
    names = [f"v{j}" for j in range(c)] + ["label"]
    return names, np.concatenate([tok, label[:, None]], axis=1)


def nn_model_set(root, names, tokens, seed, device="cuda"):
    """A model set of the NN shape the services serve (600 → 512 → 256
    → 1, `serving_sets`' spec), ZSCALE normalization, its raw table as
    both the training data and eval set `Eval1`; `init` and `stats`
    (maxNumBin 63) on the card; the weights from `seed`, saved with the
    port's `save_model` as models/model0.nn."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.models.spec import save_model
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, names, tokens)
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["1"],
                "negTags": ["0"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeNN"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": {"algorithm": "NN"},
        "evals": [{"name": "Eval1", "dataSet": data_set}]}).save(root)
    lines = {"init": run_step(root, "init"),
             "stats": run_step(root, "stats", device)}
    save_model(os.path.join(root, "models", "model0.nn"), "nn",
               {"spec": {"input_dim": NN_IN, "hidden_dims": list(NN_HIDDEN),
                         "activations": ["relu", "relu"]}},
               nn_params(np.random.default_rng(seed)))
    return lines


def phase_nn_eval(report, workdir, device="cuda", rows=NN_EVAL_ROWS,
                  cpu_rows=NN_POST_CPU_ROWS):
    """Phase 11: eval of the wide NN over a ZSCALE set through K1, card
    against CPU, then posttrain timed on the card; beside them,
    posttrain held against the CPU on a copy of the set whose raw file
    holds the first `cpu_rows` rows."""
    import shutil
    t0 = time.perf_counter()
    names, tokens = nn_raw_table(np.random.default_rng(81), rows)
    root = os.path.join(workdir, "nn")
    steps = nn_model_set(root, names, tokens, 82, device)
    print(f"  raw table, init and stats: {time.perf_counter() - t0:.1f} s "
          + json.dumps(steps))
    cpu = os.path.join(workdir, "nn_cpu")
    shutil.copytree(root, cpu, ignore=shutil.ignore_patterns("data"))
    small = os.path.join(workdir, "nn_small")
    shutil.copytree(root, small, ignore=shutil.ignore_patterns("data"))
    write_raw(os.path.join(small, "data"), names, tokens[:cpu_rows])
    set_config(small, "dataSet", dataPath=os.path.join(small, "data"),
               headerPath=os.path.join(small, "data", ".pig_header"))
    small_cpu = os.path.join(workdir, "nn_small_cpu")
    shutil.copytree(small, small_cpu, ignore=shutil.ignore_patterns("data"))
    setup_s = time.perf_counter() - t0

    def full_size():
        lines = run_twins(root, cpu, "eval", device)
        return lines, run_step(root, "posttrain", device)
    ((card_line, cpu_line), post), (small_card, small_line) = in_parallel(
        full_size, lambda: run_twins(small, small_cpu, "posttrain", device))
    for where, line in (("card", card_line), ("cpu", cpu_line)):
        print(f"  eval {where}: {json.dumps(line)}")
    print(f"  posttrain card, {rows} rows: {json.dumps(post)}")
    print(f"  posttrain {cpu_rows} rows: card {json.dumps(small_card)}, "
          f"cpu {json.dumps(small_line)}")
    assert card_line["rows"] == rows, card_line
    assert card_line["launches"]["fused_score"] > 0, \
        "NN eval on the card launched no fused_score"
    errs = compare_eval_dir(root, cpu, "Eval1", 1e-5)
    print("  NN eval card = CPU within 1e-5: " + json.dumps(errs))
    post_err = compare_posttrain(small, small_cpu, 1e-4, 1e-5)
    print("  NN posttrain card = CPU: " + json.dumps(post_err))
    report["fused_score"]["launches"] += card_line["launches"]["fused_score"]
    report["eval_nn"] = {"rows": rows, "setup_s": setup_s, "steps": steps,
                         "eval": {"card": card_line, "cpu": cpu_line},
                         "posttrain": post, "errors": errs,
                         "posttrain_small": {"card": small_card,
                                             "cpu": small_line,
                                             "errors": post_err}}


def eval_walls(rows=HIGGS_ROWS, reps=2):
    """The step times of `posttrain` and `eval`, each process with the
    host to itself (the main run holds them against their CPU twins
    side by side, so its step lines time a shared host). Phase 8's sets
    (GBT 10 trees, log loss; RF 10 trees; trained by the port on the
    card from 262,144 rows) with its 262,144-row holdout: `posttrain`,
    `eval`, and on the GBT `eval -score` and `-norm`; phase 11's NN at
    65,536 × 600: `eval` and `posttrain`; then `eval` of the GBT + RF
    ensemble over a `rows`-row file of phase 8's table. Each card step
    runs `reps` times in turns, then once with `--device cpu` (the NN's
    `posttrain` there on its first 4,096 rows). Returns each step's
    JSON lines. It calls only the CLI verbs, so it times another tree
    of the package as well (`python3 chip_smoke.py --eval-walls` from a
    copy of that tree with this script in its root)."""
    import shutil
    out = {}

    def timed(key, root, verb, cpu_root=None):
        lines = [run_step(root, verb, "cuda") for _ in range(reps)]
        lines.append(run_step(cpu_root or root, verb, "cpu"))
        out[key] = {"card": lines[:-1], "cpu": lines[-1]}
        print(f"  {key}: " + json.dumps(out[key]))

    with tempfile.TemporaryDirectory() as workdir:
        gbt = os.path.join(workdir, "gbt")
        write_model_set(gbt, "GBT", {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                                     "LearningRate": TRAIN_LR,
                                     "Loss": "log"}, 40, TRAIN_ROWS, 0.1)
        run_pipeline(gbt, "cuda")
        rf = os.path.join(workdir, "rf")
        shutil.copytree(gbt, rf, ignore=shutil.ignore_patterns("data"))
        set_config(rf, "train", algorithm="RF", validSetRate=0.0,
                   params={"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,
                           "FeatureSubsetStrategy": "SQRT"})
        for root in (gbt, rf):
            run_step(root, "train", "cuda")
        ens = os.path.join(workdir, "ens")
        shutil.copytree(gbt, ens, ignore=shutil.ignore_patterns("data"))
        shutil.copy(os.path.join(rf, "models", "model0.rf"),
                    os.path.join(ens, "models", "model1.rf"))

        holdout = os.path.join(workdir, "holdout")
        names, cols, _, _ = raw_table(np.random.default_rng(41), EVAL_ROWS,
                                      False)
        write_raw(holdout, names, cols)
        for name, root in (("gbt", gbt), ("rf", rf)):
            add_eval_set(root, "holdout", holdout)
            timed(f"{name} posttrain", root, "posttrain")
            timed(f"{name} eval", root, "eval")
        timed("gbt eval -score", gbt, ["eval", "-score"])
        timed("gbt eval -norm", gbt, ["eval", "-norm"])

        names, tokens = nn_raw_table(np.random.default_rng(81), NN_EVAL_ROWS)
        nn = os.path.join(workdir, "nn")
        nn_model_set(nn, names, tokens, 82)
        small = os.path.join(workdir, "nn_small")
        shutil.copytree(nn, small, ignore=shutil.ignore_patterns("data"))
        write_raw(os.path.join(small, "data"), names,
                  tokens[:NN_POST_CPU_ROWS])
        set_config(small, "dataSet", dataPath=os.path.join(small, "data"),
                   headerPath=os.path.join(small, "data", ".pig_header"))
        timed("nn eval", nn, "eval")
        timed("nn posttrain", nn, "posttrain", cpu_root=small)

        t0 = time.perf_counter()
        data = os.path.join(workdir, "walls")
        names, cols, _, _ = raw_table(np.random.default_rng(43), rows, False)
        raw_bytes = write_raw(data, names, cols)
        write_s = time.perf_counter() - t0
        add_eval_set(ens, "walls", data)
        line = run_step(ens, "eval", "cuda")
    out["ensemble eval"] = {
        "rows": line["rows"], "raw_bytes": raw_bytes, "write_s": write_s,
        "read_s": line["read_seconds"], "score_s": line["score_seconds"],
        "seconds": line["seconds"], "launches": line["launches"]}
    return out


# ---------------------------------------------------------------------------
# The NN/LR trainer: train on the card, eval through K1, timing
# ---------------------------------------------------------------------------

NN_TRAIN_CPU_ROWS = 8_192   # phase 12's card-vs-CPU sets: the first rows
NN_TRAIN_EPOCHS = 20
MC_ROWS = 16_384            # phase 12's 3-class table, the HIGGS widths
# (rows, columns, hidden, activation, lr, (short, long) epochs): the
# repo's two NN training shapes, as `bench.py` times them (1 bag, ADAM,
# 5 % validation, no early stop)
NN_TRAIN_SHAPES = {
    "wide": (300_000, 600, (512, 256), "relu", 0.02, (2, 102)),  # :90-94
    "flagship": (2_000_000, 32, (64,), "tanh", 0.05, (2, 32)),   # :76-80
}


def nn_train_fields(alg, prop, lr, hidden=NN_HIDDEN, bags=2,
                    epochs=NN_TRAIN_EPOCHS, **params):
    """`train` section of phase 12's sets: the wide NN (relu, sigmoid
    head) or LR, 2 Poisson bags, 10 % validation, no early stop; `params`
    join train#params."""
    params.update(Propagation=prop, LearningRate=lr)
    if alg == "NN":
        params.update(NumHiddenLayers=len(hidden),
                      NumHiddenNodes=list(hidden),
                      ActivationFunc=["relu"] * len(hidden))
    return {"algorithm": alg, "numTrainEpochs": epochs, "baggingNum": bags,
            "baggingWithReplacement": True, "baggingSampleRate": 1.0,
            "validSetRate": 0.1, "params": params}


def copy_config(src, dst):
    """A model set holding `src`'s ModelConfig.json and ColumnConfig.json
    (its data paths stay `src`'s)."""
    import shutil
    os.makedirs(dst)
    for f in ("ModelConfig.json", "ColumnConfig.json"):
        shutil.copy(os.path.join(src, f), os.path.join(dst, f))
    return dst


def copy_normalized(src, dst):
    """`copy_config` plus `src`'s tmp/NormalizedData: a twin that trains
    on the very matrix `src` trains on."""
    import shutil
    copy_config(src, dst)
    shutil.copytree(os.path.join(src, "tmp", "NormalizedData"),
                    os.path.join(dst, "tmp", "NormalizedData"))
    return dst


def head_rows(src_dir, dst_dir, n):
    """The header and first `n` rows of `src_dir`'s part file."""
    import itertools
    import shutil
    os.makedirs(dst_dir)
    shutil.copy(os.path.join(src_dir, ".pig_header"), dst_dir)
    with open(os.path.join(src_dir, "part-00000")) as f, \
            open(os.path.join(dst_dir, "part-00000"), "w") as g:
        g.writelines(itertools.islice(f, n))


def model_arrays(root):
    from shifu_tpu_torch.models.spec import list_models, load_model
    return [load_model(p)[2] for p in list_models(os.path.join(root,
                                                               "models"))]


def compare_training(card, cpu, card_root, cpu_root, curve_rel=None,
                     param_abs=None, best_rel=None):
    """Card and CPU `train` lines and model files of one configuration:
    per-epoch train/val errors within `curve_rel` of each curve's largest
    value and best epochs equal, every saved parameter within `param_abs`
    (absolute: a bias near zero has no scale of its own); or
    (sign-driven and adaptive rules, which part on near-zero gradients)
    each bag's best validation error within `best_rel` relative.
    Returns the largest differences (params also relative to each
    array's largest entry)."""
    out = {"best_val": [card["best_val_error"], cpu["best_val_error"]],
           "best_epoch": [card["best_epoch"], cpu["best_epoch"]]}
    if best_rel is not None:
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                  zip(card["best_val_error"], cpu["best_val_error"]))
        assert rel <= best_rel, f"best val error {rel} apart"
        out["best_val_rel"] = rel
        return out
    assert card["best_epoch"] == cpu["best_epoch"], out
    curve = 0.0
    for key in ("train_errors", "val_errors"):
        for a, b in zip(card[key], cpu[key]):
            a, b = np.asarray(a), np.asarray(b)
            curve = max(curve, float(np.abs(a - b).max() / np.abs(b).max()))
    assert curve <= curve_rel, f"curves {curve} apart"
    par, rel = 0.0, 0.0
    for ma, mb in zip(model_arrays(card_root), model_arrays(cpu_root)):
        for la, lb in zip(ma, mb):
            for k in lb:
                d = float(np.abs(la[k] - lb[k]).max())
                par = max(par, d)
                rel = max(rel, d / max(float(np.abs(lb[k]).max()), 1e-30))
    assert par <= param_abs, f"params {par} apart"
    out.update(curve_rel=curve, param_abs=par, param_rel=rel)
    return out


def mc_raw_table(rng, rows, c=GBT_COLS):
    """A 3-class table of the HIGGS widths: `c` numeric columns (2 %
    missing) and a label c0/c1/c2 cut from a noisy score of a few of
    them."""
    x = rng.normal(0, 1, (rows, c)).astype(np.float32)
    score = x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3] \
        + rng.logistic(0, 0.5, rows)
    label = np.array(["c0", "c1", "c2"])[np.digitize(score, [-0.6, 0.6])]
    x[rng.random(x.shape) < 0.02] = np.nan
    text = np.where(np.isnan(x), "?", x.astype(str))
    names = [f"f{j}" for j in range(c)] + ["label"]
    return names, np.concatenate([text, label[:, None]], axis=1)


def mc_model_set(root, workdir, device="cuda"):
    """The 3-class model set: raw table and holdout (eval set `Eval1`)
    from seeds, `init → stats → norm` (ZSCALE) on the card."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, *mc_raw_table(np.random.default_rng(83), MC_ROWS))
    holdout = os.path.join(workdir, "mc_holdout")
    write_raw(holdout, *mc_raw_table(np.random.default_rng(84), MC_ROWS))
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["c0"],
                "negTags": ["c1", "c2"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeMC"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": {"algorithm": "NN"},
        "evals": [{"name": "Eval1", "dataSet": dict(
            data_set, dataPath=holdout,
            headerPath=os.path.join(holdout, ".pig_header"))}]}).save(root)
    return run_pipeline(root, device)


def p12_roofline(root, nn=True):
    """(c) The `roofline` block the card `train` of `root` queued for its
    steps.jsonl record: ROOFLINE_FIELDS, and for the NN (`nn`) a share
    of the card's f32 peak in (0, 1] (LR's 3,600 FLOPs a row round to a
    share of 0 at four decimals)."""
    from shifu_tpu_torch.profiling import ROOFLINE_FIELDS
    rec = [r for r in _steps_records(root) if r["step"] == "train"][-1]
    roof = rec.get("roofline")
    assert roof is not None and tuple(roof) == ROOFLINE_FIELDS, rec
    assert 0 < roof["mxu_util"] <= 1 or not nn, roof
    print(f"  (c) train roofline of {os.path.basename(root)}: "
          + json.dumps(roof))
    return roof


def phase_nn_train(report, workdir, device="cuda", cpu_rows=NN_TRAIN_CPU_ROWS,
                   walls=True):
    """Phase 12: the NN/LR trainer on the card. Phase 11's set (its
    600-column table, `init` and `stats` done on the card) gets `norm`
    ZSCALE on the card, at full size and on its first `cpu_rows` rows.
    On those rows `train` runs on the card and with `--device cpu` from
    the same matrix: the wide NN under B and M (curves within 1e-5,
    params within 1e-4), LR under R and the NN under ADAM (best val error
    within 1e-3). At full size the card trains the NN (ADAM) and LR (R),
    and `eval` of each runs on the card (through K1) and on a CPU twin
    with phase 11's gates. Then a 3-class table of the HIGGS widths:
    NATIVE and ONEVSALL NNs trained and evaluated on the card and the
    CPU (the C×C matrix within one row's share). Last, `nn_sync_gate`
    (card only; the timings are `--nn-train-walls`' alone)."""
    t0 = time.perf_counter()
    nn = os.path.join(workdir, "nn")
    big = copy_config(nn, os.path.join(workdir, "nn_train"))
    small = copy_config(nn, os.path.join(workdir, "nn_train_small"))
    head_rows(os.path.join(nn, "data"), os.path.join(small, "data"),
              cpu_rows)
    set_config(small, "dataSet", dataPath=os.path.join(small, "data"),
               headerPath=os.path.join(small, "data", ".pig_header"))
    mc = os.path.join(workdir, "mc")
    norm_big, norm_small, mc_steps = in_parallel(
        lambda: run_step(big, "norm", device),
        lambda: run_step(small, "norm", device),
        lambda: mc_model_set(mc, workdir, device))
    print(f"  norm, card: {json.dumps(norm_big)} {json.dumps(norm_small)}")
    print(f"  3-class set: {json.dumps(mc_steps)}")

    configs = {"NN B": nn_train_fields("NN", "B", 0.1),
               "NN M": nn_train_fields("NN", "M", 0.05, Momentum=0.5),
               "LR R": nn_train_fields("LR", "R", 0.1),
               "NN ADAM": nn_train_fields("NN", "ADAM", 0.002)}
    gates = {"NN B": {"curve_rel": 1e-5, "param_abs": 1e-4},
             "NN M": {"curve_rel": 1e-5, "param_abs": 1e-4},
             "LR R": {"best_rel": 1e-3}, "NN ADAM": {"best_rel": 1e-3}}

    def twins(name):
        key = name.replace(" ", "_")
        card = copy_normalized(small, os.path.join(workdir, key))
        cpu = copy_normalized(small, os.path.join(workdir, key + "_cpu"))
        for root in (card, cpu):
            set_config(root, "train", **configs[name])
        return run_twins(card, cpu, "train", device) + (card, cpu)

    def full(name):
        root = copy_normalized(big, os.path.join(workdir, "full_" + name))
        set_config(root, "train", **configs[name])
        line = run_step(root, "train", device)
        cpu = copy_config(root, root + "_cpu")
        import shutil
        shutil.copytree(os.path.join(root, "models"),
                        os.path.join(cpu, "models"))
        return line, run_twins(root, cpu, "eval", device), root, cpu

    def mc_twins(method):
        card = copy_normalized(mc, os.path.join(workdir, "mc_" + method))
        cpu = copy_normalized(mc, os.path.join(workdir, "mc_cpu_" + method))
        for root in (card, cpu):
            set_config(root, "train", multiClassifyMethod=method,
                       **nn_train_fields("NN", "M", 0.1, hidden=(64,),
                                         bags=1 if method == "ONEVSALL"
                                         else 2, Momentum=0.5))
        lines = run_twins(card, cpu, "train", device)
        return lines, run_twins(card, cpu, "eval", device), card, cpu

    results = in_parallel(
        lambda: [twins("NN B"), twins("NN M")],
        lambda: [twins("LR R"), twins("NN ADAM")],
        lambda: [full("NN ADAM"), full("LR R")],
        lambda: [mc_twins("NATIVE"), mc_twins("ONEVSALL")])
    setup_s = time.perf_counter() - t0
    out = {"norm": [norm_big, norm_small], "mc_steps": mc_steps,
           "twins": {}, "full": {}, "multiclass": {}}
    for name, (card, cpu, card_root, cpu_root) in zip(
            configs, results[0] + results[1]):
        print(f"  train {name}, {cpu_rows} rows: card {json.dumps(card)}")
        print(f"  train {name}, {cpu_rows} rows: cpu {json.dumps(cpu)}")
        assert card["device"].startswith(device) and card["bags"] == 2
        errs = compare_training(card, cpu, card_root, cpu_root,
                                **gates[name])
        print(f"  {name} card = CPU: {json.dumps(errs)}")
        out["twins"][name] = {"card": card, "cpu": cpu, "errors": errs}
    for name, (line, (card_eval, cpu_eval), root, cpu) in zip(
            ("NN ADAM", "LR R"), results[2]):
        print(f"  train {name}, {line['rows']} rows, card: "
              + json.dumps({k: v for k, v in line.items()
                            if not k.endswith("_errors")}))
        print(f"  eval of it: card {json.dumps(card_eval)}, "
              f"cpu {json.dumps(cpu_eval)}")
        assert card_eval["launches"]["fused_score"] > 0, \
            f"eval of the card-trained {name} launched no fused_score"
        errs = compare_eval_dir(root, cpu, "Eval1", 1e-5)
        print(f"  {name} eval card = CPU within 1e-5: {json.dumps(errs)}")
        report["fused_score"]["launches"] += \
            card_eval["launches"]["fused_score"]
        roof = p12_roofline(root, nn=name.startswith("NN"))
        out["full"][name] = {"train": line, "eval": {"card": card_eval,
                                                     "cpu": cpu_eval},
                             "errors": errs, "roofline": roof}
    for method, ((card, cpu), (card_eval, cpu_eval), croot, cpu_root) in zip(
            ("NATIVE", "ONEVSALL"), results[3]):
        print(f"  3-class {method} train: card {json.dumps(card)}, "
              f"cpu {json.dumps(cpu)}")
        print(f"  3-class {method} eval: card {json.dumps(card_eval)}, "
              f"cpu {json.dumps(cpu_eval)}")
        # two trainings (card, CPU) whose f32 sums part at 1e-7 an epoch:
        # class scores within 1e-4, the C×C matrix within a row's share
        errs = compare_multiclass_eval(croot, cpu_root, "Eval1", 1e-4,
                                       rows=1)
        print(f"  3-class {method} eval card = CPU: {json.dumps(errs)}")
        out["multiclass"][method] = {"train": {"card": card, "cpu": cpu},
                                     "eval": {"card": card_eval,
                                              "cpu": cpu_eval},
                                     "errors": errs}
    out["setup_and_gates_s"] = setup_s
    if walls:
        out["sync_free_epochs"] = nn_sync_gate(device)
    report["nn_train"] = out


def _flops_per_row(dims):
    """`bench.py:54-57`: training FLOPs a row, forward 2·Σ d_i·d_{i+1},
    backward about twice that."""
    return 3 * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _walls_inputs(rows, cols, hidden, act, lr):
    """A shape's rows from a seed and its train params (1 bag, ADAM, 5 %
    validation, no early stop)."""
    from shifu_tpu_torch.config.model_config import ModelTrainConf
    rng = np.random.default_rng(85)
    x = rng.standard_normal((rows, cols), dtype=np.float32)
    beta = rng.standard_normal(cols).astype(np.float32)
    y = (x @ beta / np.sqrt(cols) * 2.0 + rng.standard_normal(rows)
         > 0).astype(np.float32)
    params = {"NumHiddenLayers": len(hidden), "NumHiddenNodes": list(hidden),
              "ActivationFunc": [act] * len(hidden),
              "Propagation": "ADAM", "LearningRate": lr}
    conf = ModelTrainConf()
    conf.params, conf.baggingNum, conf.validSetRate = params, 1, 0.05
    conf.earlyStoppingRounds, conf.convergenceThreshold = 0, 0.0
    return x, y, np.ones(rows, np.float32), conf


def _epoch_loop(x, y, params, spec, device="cuda"):
    """`run(n)`: `train_bags_carry` for n epochs on inputs already on the
    card, from fresh initial params."""
    import torch
    from shifu_tpu_torch import weights
    from shifu_tpu_torch.models import nn as nn_mod
    from shifu_tpu_torch.train import trainer
    from shifu_tpu_torch.train.optimizers import optimizer_from_params
    dev = torch.device(device)
    tr, va = trainer.split_validation(len(y), 0.05, 1)
    xt, yt = (torch.as_tensor(a).to(dev) for a in (x[tr], y[tr]))
    xv, yv = (torch.as_tensor(a).to(dev) for a in (x[va], y[va]))
    wt = torch.ones((1, len(yt)), device=dev)
    wv = torch.ones(len(yv), device=dev)
    stacked = [{k: v.to(dev) for k, v in layer.items()} for layer in
               weights.stack_nn_params([nn_mod.init_params(
                   spec, torch.Generator().manual_seed(1))])]
    mask = [{k: torch.ones_like(v[0]) for k, v in layer.items()}
            for layer in stacked]
    opt = optimizer_from_params(params)

    def run(n):
        carry = trainer.init_train_carry(opt, stacked)
        return trainer.train_bags_carry(
            lambda p, i, w_, g: nn_mod.loss_fn(spec, p, *i, w_, g),
            lambda p, i, w_: nn_mod.mse(spec, p, *i, w_), opt, n, 0,
            0.0, carry, (xt, yt), wt, (xv, yv), wv, mask)
    return run


def _sync_free(run):
    """Five epochs of `run` under `torch.cuda.set_sync_debug_mode
    ("error")`, which raises on any host sync inside the epoch loop."""
    import torch
    run(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return 5


def nn_sync_gate(device="cuda", shapes=NN_TRAIN_SHAPES):
    """`nn_train_walls`' gate alone, in this process: at each of the
    repo's two NN training shapes, five epochs of the trainer's epoch
    loop with no host sync (`_sync_free`). Returns the epochs a shape."""
    from shifu_tpu_torch.models import nn as nn_mod
    out = {}
    for name, (rows, cols, hidden, act, lr, _) in shapes.items():
        x, y, _, conf = _walls_inputs(rows, cols, hidden, act, lr)
        spec = nn_mod.MLPSpec.from_train_params(conf.params, cols)
        out[name] = _sync_free(_epoch_loop(x, y, conf.params, spec, device))
        del x
    print(f"  nn sync-free epochs: {json.dumps(out)}")
    return out


def nn_train_walls(shapes=NN_TRAIN_SHAPES, device="cuda"):
    """The trainer's speed at the repo's two NN training shapes, card
    only, `bench.py`'s method: `train_nn` (1 bag, ADAM, 5 % validation,
    no early stop, rows from a seed) at a short and a long epoch count,
    so the host→device copy and the result fetch cancel in the
    difference. Per shape: row·epochs/s, ms an epoch, the share of the
    card's f32 peak by `bench.py`'s FLOPs a row, the launches an epoch
    (kernels between markers, three epochs less one, halved), the
    device's idle share over five profiled epochs, and that five epochs
    run with `torch.cuda.set_sync_debug_mode("error")` (no host sync in
    the loop)."""
    import torch
    from shifu_tpu_torch.train import trainer
    out = {}
    for name, (rows, cols, hidden, act, lr, (short, long_)) in \
            shapes.items():
        x, y, w, conf = _walls_inputs(rows, cols, hidden, act, lr)
        walls = {}
        for epochs in (short, short, long_):     # the first call warms up
            conf.numTrainEpochs = epochs
            t0 = time.perf_counter()
            res = trainer.train_nn(conf, x, y, w, seed=1, device=device)
            walls[epochs] = time.perf_counter() - t0
        d_wall = walls[long_] - walls[short]
        d_epochs = long_ - short
        n_train = res.rows
        spec = res.spec
        flops = _flops_per_row(spec.layer_dims) * n_train * d_epochs
        # the epoch loop itself, on inputs already on the card
        run = _epoch_loop(x, y, conf.params, spec, device)
        sync_free = _sync_free(run)
        one = len(kernels_between_markers(lambda: run(1)))
        three = len(kernels_between_markers(lambda: run(3)))
        wall_ms, dev_ms = device_busy(lambda: run(5))
        out[name] = {
            "rows": rows, "train_rows": n_train, "dims": spec.layer_dims,
            "epochs": [short, long_],
            "wall_s": {str(k): v for k, v in walls.items()},
            "row_epochs_per_s": n_train * d_epochs / d_wall,
            "ms_per_epoch": d_wall / d_epochs * 1e3,
            "f32_peak_share": flops / d_wall / F32_PEAK,
            "flops_per_row": _flops_per_row(spec.layer_dims),
            "launches_per_epoch": (three - one) / 2,
            "launches_one_epoch_run": one,
            "profiled_5_epochs_ms": wall_ms, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall_ms,
            "sync_free_epochs": sync_free,
            "best_val": float(res.best_val[0])}
        print(f"  nn train walls {name}: " + json.dumps(out[name]))
        del x, run
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: varselect, the stats flags, export and encode
# ---------------------------------------------------------------------------

VS_ROWS = 262_144           # phase 13's HIGGS table with month and day
PMML_ROWS = 4_096           # raw holdout rows the PMML documents score
VS_FILTER_NUM = 15          # of the HIGGS table's 30 candidates
V_CPU_ROWS = 32_768         # V card against CPU on the table's first rows
SE_TRAIN = {"algorithm": "NN", "numTrainEpochs": 20, "baggingNum": 1,
            "validSetRate": 0.1,
            "params": {"NumHiddenLayers": 1, "NumHiddenNodes": [64],
                       "ActivationFunc": ["tanh"], "Propagation": "B",
                       "LearningRate": 0.1}}
FI_TRAIN = {"algorithm": "RF", "validSetRate": 0.0, "params": {
    "TreeNum": 10, "MaxDepth": TRAIN_DEPTH, "FeatureSubsetStrategy": "SQRT"}}
# verbs whose parser takes --device
_DEVICE_VERBS = ("stats", "norm", "varsel", "varselect", "train",
                 "posttrain", "eval", "export", "encode")


def run_verbs(steps, device):
    """Each (root, args) of `steps` through `cli.main` in this process,
    with ``--device`` where the verb takes one; returns each step's JSON
    line, the lines it printed before it under ``printed``."""
    import contextlib
    import io
    from shifu_tpu_torch import cli
    out = []
    for root, args in steps:
        buf = io.StringIO()
        extra = ["--device", device] if args[0] in _DEVICE_VERBS else []
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--dir", root, *args, *extra])
        lines = buf.getvalue().strip().splitlines()
        line = json.loads(lines[-1])
        line.update(rc=rc, printed=lines[:-1])
        out.append(line)
    return out


def start_cpu_verbs(steps, workdir):
    """`run_verbs(steps, "cpu")` in a process of its own (`--cpu-verbs`),
    for `beside`: returns (process, what)."""
    path = os.path.join(workdir, f"cpu_steps_{len(os.listdir(workdir))}.json")
    with open(path, "w") as f:
        json.dump(steps, f)
    return (_spawn([os.path.abspath(__file__), "--cpu-verbs", path],
                   CPU_TWIN_ENV), f"--cpu-verbs {path}")


def vs_model_set(root, rows):
    """Phase 13's set: phase 10's HIGGS widths (28 numeric + 2
    categorical, weight, meta) with the `month` cohort and `day` date
    columns, RF (10 trees, depth 6, SQRT) as its algorithm."""
    raw_bytes = write_model_set(root, "RF", FI_TRAIN["params"], 77, rows,
                                0.0, extras=True, cohorts=True)
    set_config(root, "varSelect", filterNum=VS_FILTER_NUM)
    return raw_bytes


def read_csv_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def compare_date_stats(card_path, cpu_path, rtol=1e-5):
    """DateStats.csv card against CPU: the same (date, column) rows; each
    printed value within `rtol` of its scale (the larger of |value| and
    the largest |value| of that metric and column over the dates: a mean
    near zero has no scale of its own) plus one unit of its sixth
    printed digit (`%.6g`). Returns the largest difference in units of
    the scale."""
    a, b = read_csv_rows(card_path), read_csv_rows(cpu_path)
    assert a[0] == b[0] and len(a) == len(b)
    assert [r[:2] for r in a] == [r[:2] for r in b]
    cols = np.asarray([r[1] for r in b[1:]])
    va = np.asarray([[float(v) for v in r[2:]] for r in a[1:]])
    vb = np.asarray([[float(v) for v in r[2:]] for r in b[1:]])
    finite = np.isfinite(vb)
    same = (va == vb) | ~finite
    scale = np.abs(np.where(finite, vb, 0.0))
    for c in np.unique(cols):
        rows = cols == c
        scale[rows] = np.maximum(scale[rows], scale[rows].max(axis=0))
    mag = np.maximum(np.abs(np.where(finite, va, 0)), scale)
    unit = 10.0 ** (np.floor(np.log10(np.maximum(mag, 1e-300))) - 5)
    diff = np.where(same, 0.0, np.abs(va - vb))
    assert (diff <= rtol * scale + unit).all(), \
        "DateStats.csv card vs CPU beyond tolerance"
    return float((diff / np.maximum(scale, 1e-30)).max())


def date_stats_arrays(root, device):
    """`datestat.compute_date_stats` of the set's stats rows on
    `device`, as `stats` computes them."""
    from shifu_tpu_torch.data.dataset import build_columnar, valid_tag_mask
    from shifu_tpu_torch.data.reader import string_column
    from shifu_tpu_torch.processor import datestat
    from shifu_tpu_torch.processor import stats as stats_proc
    from shifu_tpu_torch.processor.base import ProcessorContext
    ctx = ProcessorContext.load(root)
    mc = ctx.model_config
    df = stats_proc._resident_frame(ctx, 12306)
    dset = build_columnar(mc, [c for c in ctx.column_configs
                               if not c.is_segment], df)
    dates = string_column(df[datestat.date_column_name(mc)])[
        valid_tag_mask(mc, df)]
    uniq, ids = np.unique(dates, return_inverse=True)
    return datestat.compute_date_stats(dset.numeric, dset.tags,
                                       ids.reshape(-1), len(uniq), device)


def compare_date_arrays(a, b, rtol=1e-5):
    """DateStats card against CPU before printing: each metric within
    `rtol` of the larger of its value and the largest |value| of that
    metric in its column (a mean near zero has no scale of its own: its
    f32 sum parts by the sum's rounding). Returns the largest such
    difference."""
    err = 0.0
    for k in b:
        scale = np.maximum(np.abs(b[k]), np.nanmax(
            np.where(np.isfinite(b[k]), np.abs(b[k]), 0.0), axis=0))
        same_inf = (a[k] == b[k]) & ~np.isfinite(b[k])
        d = np.where(same_inf, 0.0, np.abs(a[k] - b[k])
                     / np.maximum(scale, 1e-30))
        err = max(err, float(np.max(d)))
    assert err <= rtol, f"DateStats card vs CPU {err}"
    return err


def compare_corr(card_path, cpu_path, tol=1e-5):
    a, b = read_csv_rows(card_path), read_csv_rows(cpu_path)
    assert a[0] == b[0] and [r[0] for r in a] == [r[0] for r in b]
    va = np.asarray([[float(v) for v in r[1:]] for r in a[1:]])
    vb = np.asarray([[float(v) for v in r[1:]] for r in b[1:]])
    err = float(np.abs(va - vb).max())
    assert err <= tol, f"correlation card vs CPU {err}"
    return err


def column_configs(root):
    with open(os.path.join(root, "ColumnConfig.json")) as f:
        return json.load(f)


def selection(root):
    return [c["columnName"] for c in column_configs(root) if c["finalSelect"]]


def same_bytes(a, b, what):
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read(), f"{what}: the files differ"


def se_file(root):
    with open(os.path.join(root, "varsel", "se.0")) as f:
        return dict((n, float(v)) for n, v in
                    (line.split("\t") for line in f))


def compare_se(card, cpu, filter_num, tol=1e-4):
    """se.0 deltas card against CPU within `tol` of the largest; the
    selections equal, except columns whose delta lies within that
    tolerance of the cut (the `filter_num`-th delta)."""
    a, b = se_file(card), se_file(cpu)
    assert set(a) == set(b)
    scale = max(abs(v) for v in b.values())
    err = max(abs(a[k] - b[k]) for k in b) / scale
    assert err <= tol, f"se.0 deltas {err} of the largest apart"
    cut = sorted(b.values(), reverse=True)[min(filter_num, len(b)) - 1]
    diff = set(selection(card)) ^ set(selection(cpu))
    near = {k for k in diff if abs(b[k] - cut) <= tol * scale}
    assert diff == near, f"selections differ beyond the cut's tie: {diff}"
    return {"delta_rel": err, "flipped_at_cut": sorted(diff)}


def compare_voted(card_line, cpu_line, card, cpu, rtol=1e-4):
    """V card against CPU: each generation's best validation error within
    `rtol` relative and the selections equal; a one-column swap is
    accepted only where the final population's errors agree within
    `rtol` (a near tie in the vote), and then reported."""
    g_card = np.asarray(card_line["generations"])
    g_cpu = np.asarray(cpu_line["generations"])
    rel = float(np.max(np.abs(g_card - g_cpu) / np.abs(g_cpu)))
    assert rel <= rtol, f"V best errors {g_card} vs {g_cpu}"
    out = {"generations_rel": rel, "card": g_card.tolist(),
           "cpu": g_cpu.tolist()}
    diff = set(selection(card)) ^ set(selection(cpu))
    if diff:
        fa = np.asarray(card_line["final_errors"])
        fb = np.asarray(cpu_line["final_errors"])
        final_rel = float(np.max(np.abs(fa - fb) / np.abs(fb)))
        print(f"  V: selections differ in {sorted(diff)}; final errors "
              f"card {fa.tolist()} cpu {fb.tolist()}")
        assert len(diff) == 2 and final_rel <= rtol, \
            f"V selections differ in {sorted(diff)}"
        out["near_tie_swap"] = sorted(diff)
    return out


def zip_members(path):
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def model_copy(src, dst):
    """`copy_config(src, dst)` with `src`'s models/."""
    import shutil
    copy_config(src, dst)
    shutil.copytree(os.path.join(src, "models"), os.path.join(dst, "models"))
    return dst


def pmml_scores(root, twin, records_table, n):
    """Each PMML document of `root` (one parse a document): byte-equal to
    the CPU twin's (in `twin`), its `validate_structure` problems, and
    its `evaluate_pmml` scores over the first `n` rows of a raw table.
    Returns (problems, scores)."""
    import xml.etree.ElementTree as ET
    from shifu_tpu_torch import pmml
    from shifu_tpu_torch.data.reader import Table
    recs = Table({k: np.where(records_table[k][:n] == "?", "",
                              records_table[k][:n])
                  for k in records_table.columns})
    d = os.path.join(root, "pmmls")
    problems, scores = [], []
    for f in sorted(os.listdir(d)):
        same_bytes(os.path.join(d, f), os.path.join(twin, "pmmls", f),
                   f"pmml {f}")
        doc = ET.parse(os.path.join(d, f)).getroot()
        problems += pmml.validate_structure(doc)
        scores.append(pmml.evaluate_pmml(doc, recs))
    return problems, scores


def card_scores(root, table, n, device):
    """`Scorer.score`'s mean on the card over the same rows, normalized
    as posttrain does; returns (scores, K1 launches, K2 launches)."""
    from shifu_tpu_torch.config.column_config import load_column_configs
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.processor import norm as norm_proc
    mc = ModelConfig.load(root)
    ccs = load_column_configs(os.path.join(root, "ColumnConfig.json"))
    cols = norm_proc.selected_candidates(ccs)
    from shifu_tpu_torch.data.reader import Table
    head = Table({k: table[k][:n] for k in table.columns})
    dset = norm_proc.load_dataset_for_columns(mc, ccs, cols, df=head)
    res = norm_proc.normalize_columns(mc, cols, dset, device=device)
    scorer = Scorer.from_dir(os.path.join(root, "models"), device=device)
    # a plain z-score set advertises its (mean, std), as eval does, so
    # the NN/LR path reads the raw block through K1
    norm = None if res.zscore_params is None else {
        "mean": res.zscore_params[0], "std": res.zscore_params[1],
        "cutoff": mc.normalize.stdDevCutOff}
    k1, k2 = fused_score.launches, fused_trees.launches
    out = scorer.score(res.dense, res.index if res.index.size else None,
                       raw_dense=dset.numeric,
                       raw_codes=dset.cleaned_codes(), norm=norm)["mean"]
    return out, fused_score.launches - k1, fused_trees.launches - k2


def manage_round_trip(src, workdir):
    """`new`, then `save v1` / an edit (`varsel -reset`) / `save v2` /
    `switch v1` / `show` on a copy of `src`: the restored files equal
    the v1 snapshot (but the CLI's step log, which each verb appends
    to)."""
    def files(root, skip=".shifu-versions"):
        out = {}
        for d, dirs, fs in os.walk(root):
            dirs[:] = [x for x in dirs if x != skip]
            for f in fs:
                p = os.path.join(d, f)
                with open(p, "rb") as h:
                    out[os.path.relpath(p, root)] = h.read()
        out.pop(os.path.join("tmp", "metrics", "steps.jsonl"), None)
        return out
    root = model_copy(src, os.path.join(workdir, "manage"))
    lines = run_verbs([(workdir, ["new", "scaffold"]),
                       (root, ["save", "v1"])], "cpu")
    v1 = files(root)
    lines += run_verbs([(root, ["varsel", "-reset"]), (root, ["save", "v2"]),
                        (root, ["switch", "v1"]), (root, ["show"])], "cpu")
    assert all(line["rc"] == 0 for line in lines), lines
    assert files(root) == v1, "switch v1 did not restore the v1 files"
    assert lines[-1]["versions"] == ["master", "v1", "v2"], lines[-1]
    assert os.path.exists(os.path.join(workdir, "scaffold",
                                       "ModelConfig.json"))
    return [{k: v for k, v in line.items() if k != "printed"}
            for line in lines]


def count_kernels(names, *parts):
    return sum(1 for n in names if any(p in n for p in parts))


def phase_varselect_export(report, w8, w11, device="cuda", rows=VS_ROWS,
                           v_rows=V_CPU_ROWS, se_full_rows=NN_EVAL_ROWS,
                           pmml_rows=PMML_ROWS):
    """Phase 13: varselect, the stats flags, export and encode on the
    card against the CPU twin. `w8` holds phase 8's sets (the card-trained
    RF and log-loss GBT, the holdout table), `w11` phases 11 and 12's
    (the 600-column table and its card-trained LR and 2-bag wide NN)."""
    import shutil
    t0 = time.perf_counter()
    w13 = os.path.join(w11, "phase13")
    os.makedirs(w13)
    jobs = os.path.join(w13, "jobs")
    os.makedirs(jobs)
    hig = os.path.join(w13, "hig")
    raw_bytes = vs_model_set(hig, rows)
    hig_cpu = os.path.join(w13, "hig_cpu")
    shutil.copytree(hig, hig_cpu, ignore=shutil.ignore_patterns("data"))
    card, (cpu,) = beside(
        [start_cpu_verbs([(hig_cpu, ["init"]), (hig_cpu, ["stats"])], jobs)],
        lambda: run_verbs([(hig, ["init"]), (hig, ["stats"])], device))
    assert card[1]["rows"] == rows == cpu[1]["rows"], (card, cpu)
    date_err = compare_date_arrays(date_stats_arrays(hig, device),
                                   date_stats_arrays(hig, "cpu"))
    date_gap = compare_date_stats(_pf_path(hig, "date_stats_path"),
                                  _pf_path(hig_cpu, "date_stats_path"))
    print(f"  init + stats (DateStats): card {json.dumps(card[1])}, "
          f"DateStats card = CPU within {date_err:.2e} of scale "
          f"(DateStats.csv {date_gap:.2e})")
    # the CPU twin takes the card's ColumnConfig.json: every flag and
    # filter below starts from the same stats
    shutil.copy(os.path.join(hig, "ColumnConfig.json"), hig_cpu)

    # the jobs: (name, source set, edit) → a copy a side
    def side_copy(name, src_card, src_cpu, edit=None, models=False):
        out = []
        for src, tag in ((src_card, "card"), (src_cpu, "cpu")):
            dst = os.path.join(w13, f"{name}_{tag}")
            (model_copy if models else copy_config)(src, dst)
            if edit:
                edit(dst)
            out.append(dst)
        return out

    def vs(by, **fields):
        return lambda d: set_config(d, "varSelect", filterBy=by, **fields)

    sets = {f"vs_{by}": side_copy(f"vs_{by}", hig, hig_cpu, vs(by))
            for by in ("KS", "IV", "MIX", "PARETO")}
    # V's twins train on the table's first rows (a cut for the CPU twin
    # only: 20 nets × 6 trainings); the card runs it at full size too
    v_head = os.path.join(w13, "v_head")
    head_rows(os.path.join(hig, "data"), v_head, v_rows)
    v_conf = vs("V", wrapperNum=VS_FILTER_NUM, params={
        "population_live_size": 20, "population_multiply_cnt": 5})

    def v_cut(d):
        v_conf(d)
        set_config(d, "dataSet", dataPath=v_head,
                   headerPath=os.path.join(v_head, ".pig_header"))
    sets["vs_V"] = side_copy("vs_V", hig, hig_cpu, v_cut)
    v_full = copy_config(hig, os.path.join(w13, "vs_V_full"))
    v_conf(v_full)
    sets["vs_FI"] = side_copy("vs_FI", hig, hig_cpu, vs("FI"))
    sets["vs_edit"] = side_copy("vs_edit", hig, hig_cpu)
    sets["rebin"] = side_copy("rebin", hig, hig_cpu)
    for d in sets["vs_edit"]:
        with open(os.path.join(d, "pick.txt"), "w") as f:
            f.write("f0\nf3\nc1\n")
    nn_small = os.path.join(w11, "nn_train_small")

    def se_conf(by):
        def edit(d):
            set_config(d, "train", **SE_TRAIN)
            set_config(d, "varSelect", filterBy=by, filterNum=300)
        return edit
    for by in ("SE", "ST", "R"):
        sets[f"se_{by}"] = side_copy(f"se_{by}", nn_small, nn_small,
                                     se_conf("SE" if by == "R" else by))
    pmml_src = {"rf": os.path.join(w8, "rf_card"),
                "gbt": os.path.join(w8, "gbt_log_card"),
                "lr": os.path.join(w11, "full_LR R"),
                "nn": os.path.join(w11, "full_NN ADAM")}
    for k, src in pmml_src.items():
        sets[f"pmml_{k}"] = side_copy(f"pmml_{k}", src, src, models=True)
    sets["bagging"] = side_copy("bagging", pmml_src["nn"], pmml_src["nn"],
                                models=True)
    sets["encode"] = side_copy("encode", pmml_src["gbt"], pmml_src["gbt"],
                               models=True)

    def steps(i):
        """Side i's steps in two independent groups (the CPU twin runs
        each in a process of its own): the HIGGS table's flags, exports
        and filters; then the 600-column SE sets, the exports of the
        model files and encode."""
        h = hig if i == 0 else hig_cpu
        a = [(h, ["stats", "-correlation"]), (h, ["stats", "-psi"]),
             (h, ["export", "-t", "columnstats"]),
             (h, ["export", "-t", "woemapping"]),
             (h, ["export", "-t", "woe"]),
             (h, ["export", "-t", "correlation"])]
        a += [(sets[f"vs_{by}"][i], ["varsel"])
              for by in ("KS", "IV", "MIX", "PARETO", "V")]
        e = sets["vs_edit"][i]
        a += [(e, ["varsel", "-f", "pick.txt"]), (e, ["varsel", "-list"]),
              (e, ["varsel", "-reset"])]
        b = [(sets["rebin"][i], ["stats", "-rebin", "-n", "5"]),
             (sets["se_SE"][i], ["varsel"]), (sets["se_ST"][i], ["varsel"]),
             (sets["se_R"][i], ["varsel", "-r", "1"])]
        b += [(sets[f"pmml_{k}"][i], ["export", "-t", "pmml"])
              for k in ("rf", "gbt", "lr")]
        b += [(sets["pmml_nn"][i], ["export", "-t", "baggingpmml"]),
              (sets["bagging"][i], ["export", "-t", "bagging"]),
              (sets["encode"][i], ["encode"])]
        return a, b
    fi_steps = [(sets["vs_FI"][i], ["varsel"]) for i in (0, 1)]
    setup_s = time.perf_counter() - t0

    (a0, b0), (a1, b1) = steps(0), steps(1)
    fi = {}

    def card_steps():
        from shifu_tpu_torch.ops import best_splits, level_hist
        card = run_verbs(a0, device)
        # FI trains the RF on the card between marker kernels
        before = (level_hist.launches + level_hist.fused_launches,
                  best_splits.launches)
        names = kernels_between_markers(
            lambda: fi.setdefault("line", run_verbs(fi_steps[:1],
                                                    device)[0]))
        fi.update(k3k4=count_kernels(names, "level_hist"),
                  k5=count_kernels(names, "best_splits"),
                  counters=(level_hist.launches + level_hist.fused_launches
                            - before[0], best_splits.launches - before[1]))
        return card + [fi["line"]] + run_verbs(b0, device)
    card, (cpu_a, cpu_b) = beside(
        [start_cpu_verbs(a1 + fi_steps[1:], jobs), start_cpu_verbs(b1, jobs)],
        card_steps)
    cpu = cpu_a + cpu_b
    names = [" ".join(a) + " " + os.path.basename(r)
             for r, a in a0 + fi_steps[:1] + b0]
    lines = dict(zip(names, zip(card, cpu)))
    for name, (a, b) in lines.items():
        assert a["rc"] == 0 and b["rc"] == 0, (name, a, b)
        short = {k: v for k, v in a.items()
                 if k not in ("printed", "final_errors")}
        print(f"  {name}: card {json.dumps(short)}; CPU twin "
              f"{b['seconds']:.2f} s")
    errs = {"date_stats": date_err, "date_stats_csv": date_gap}
    failed = []

    def gate(name, fn):
        """Run one gate; a failed one is printed and the phase goes on,
        so a run reports every gate (the phase fails at its end)."""
        try:
            out = fn()
        except AssertionError as e:
            print(f"  GATE FAILED {name}: {e}")
            failed.append(f"{name}: {e}")
            return None
        if out is not None:
            errs[name] = out
        return out

    # 1. the stats flags and their exports
    gate("correlation", lambda: compare_corr(
        _pf_path(hig, "correlation_path"),
        _pf_path(hig_cpu, "correlation_path")))

    def psi_gate():
        a, b = column_configs(hig), column_configs(hig_cpu)
        psi = max(abs(x["columnStats"]["psi"] - y["columnStats"]["psi"])
                  for x, y in zip(a, b)
                  if y["columnStats"].get("psi") is not None)
        assert psi <= 1e-6, f"psi card vs CPU {psi}"
        assert [x["columnStats"].get("unitStats") for x in a] == \
            [y["columnStats"].get("unitStats") for y in b]
        return psi
    gate("psi", psi_gate)

    def files_gate():
        assert column_configs(sets["rebin"][0]) == \
            column_configs(sets["rebin"][1]), "rebin ColumnConfig differs"
        for rel in ("woemapping.csv", "varwoe_info.txt"):
            same_bytes(os.path.join(hig, rel), os.path.join(hig_cpu, rel),
                       rel)
        same_bytes(_pf_path(hig, "column_stats_export_path"),
                   _pf_path(hig_cpu, "column_stats_export_path"),
                   "columnstats")
    gate("rebin and exports", files_gate)
    print(f"  stats flags card = CPU: DateStats {date_err:.2e}, Pearson "
          f"{errs.get('correlation')}, psi {errs.get('psi')}; rebin "
          "ColumnConfig, columnstats, woemapping, woe")

    # 2. varselect on the HIGGS table
    def selections_gate():
        for by in ("KS", "IV", "MIX", "PARETO", "FI"):
            c, p = sets[f"vs_{by}"]
            assert selection(c) == selection(p) and selection(c), \
                f"{by}: {selection(c)} vs {selection(p)}"
        listed = lines["varsel -list vs_edit_card"][0]["printed"]
        assert listed == ["f0", "f3", "c1"], listed
        assert selection(sets["vs_edit"][0]) == \
            selection(sets["vs_edit"][1]) == []
    gate("selections", selections_gate)
    gate("V", lambda: compare_voted(lines["varsel vs_V_card"][0],
                                    lines["varsel vs_V_card"][1],
                                    *sets["vs_V"]))

    def fi_gate():
        assert fi["k3k4"] > 0 and fi["k5"] > 0, \
            f"FI varselect launched K3/K4 {fi['k3k4']}, K5 {fi['k5']}"
    gate("FI launches", fi_gate)
    print(f"  varselect selections, -f/-list/-reset; V "
          f"{json.dumps(errs.get('V'))}; FI between markers: K3/K4 "
          f"{fi['k3k4']}, K5 {fi['k5']} (counters {fi['counters']})")

    # 3. SE, ST and -r 1 on the 600-column set's first rows, then the
    # card alone at the full table
    for by in ("SE", "ST", "R"):
        gate(f"se_{by}", lambda by=by: compare_se(*sets[f"se_{by}"], 300))
    se_full = copy_config(os.path.join(w11, "nn"), os.path.join(w13,
                                                                "se_full"))
    se_conf("SE")(se_full)
    se_line, v_line = run_verbs([(se_full, ["varsel"]), (v_full, ["varsel"])],
                                device)
    assert se_line["rows"] == se_full_rows, se_line
    assert v_line["rows"] == rows and len(v_line["generations"]) == 5, \
        v_line
    print(f"  V on the card at {rows} rows: {v_line['seconds']:.2f} s, best "
          f"errors {v_line['generations']}")
    print("  SE/ST/-r 1 card = CPU: " + json.dumps(
        {k: v for k, v in errs.items() if k.startswith("se_")})
        + f"; SE on the card at {se_full_rows} x {NN_IN}: "
        f"{se_line['seconds']:.2f} s")

    # 4. export and convert
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.data.reader import read_raw_table
    gbt_mc = ModelConfig.load(pmml_src["gbt"])
    holdout = read_raw_table(gbt_mc, ds=gbt_mc.evals[0].dataSet,
                             max_rows=pmml_rows)
    nn_table = read_raw_table(ModelConfig.load(pmml_src["nn"]),
                              max_rows=pmml_rows)
    pm = {}
    launched = {"fused_score": 0, "fused_trees": 0}
    for k in ("rf", "gbt", "lr", "nn"):
        c, p = sets[f"pmml_{k}"]
        t_check = time.perf_counter()

        table = holdout if k in ("rf", "gbt") else nn_table
        problems, docs = pmml_scores(c, p, table, pmml_rows)

        def docs_gate(problems=problems):
            assert problems == [], problems
        gate(f"pmml {k} conformance", docs_gate)
        box = {}
        kname = "fused_trees" if k in ("rf", "gbt") else "fused_score"
        try:
            kn = count_kernels(kernels_between_markers(lambda: box.setdefault(
                "s", card_scores(c, table, pmml_rows, device))), kname)
        except AssertionError as e:
            # every trace lost a marker: the wrapper's launch counter
            # (the first call's, in `box`) stands in for the kernel count
            print(f"  PMML check {k}: {e}; the launch counter counts")
            kn = None
        want, d1, d2 = box["s"]
        launched["fused_score"] += d1
        launched["fused_trees"] += d2
        got = docs[0] if k == "nn" else np.mean(docs, axis=0)
        pm[k] = {"max_abs_err": float(np.abs(got - want).max()),
                 "launches": kn if kn is not None else
                 (d2 if k in ("rf", "gbt") else d1),
                 "check_s": time.perf_counter() - t_check}

        def score_gate(k=k, got=got, kname=kname):
            tol = 1e-6 if k in ("rf", "gbt") else 1e-5
            assert got.shape == (pmml_rows,) and np.isfinite(got).all()
            assert pm[k]["max_abs_err"] <= tol, \
                f"PMML {k}: {pm[k]['max_abs_err']} from Scorer.score"
            assert pm[k]["launches"] > 0, f"PMML check {k}: no {kname}"
        gate(f"pmml {k} scores", score_gate)

    def bagging_gate():
        name = os.path.join("onebagging", "smokeNN.bagging")
        assert zip_members(os.path.join(sets["bagging"][0], name)) == \
            zip_members(os.path.join(sets["bagging"][1], name)), \
            "bagging zip members differ"
    gate("bagging", bagging_gate)
    from shifu_tpu_torch.models.spec import _flatten, load_model
    spec = os.path.join(sets["bagging"][0], "models", "model0.nn")
    conv = run_verbs([(w13, ["convert", spec, os.path.join(w13, "nn0")]),
                      (w13, ["convert", os.path.join(w13, "nn0.zip"),
                             os.path.join(w13, "nn0.back")])], device)

    def convert_gate():
        ka, ma, pa = load_model(spec)
        kb, mb, pb = load_model(os.path.join(w13, "nn0.back"))
        fa, fb = _flatten(pa), _flatten(pb)
        assert (ka, ma) == (kb, mb) and set(fa) == set(fb)
        assert all(np.array_equal(fa[x], fb[x]) for x in fa)
    gate("convert", convert_gate)
    print(f"  PMML files card = CPU and conformant; evaluate_pmml vs "
          f"Scorer.score on the card: {json.dumps(pm)}; bagging; convert "
          f"round trip")

    # 5. encode, 6. new / save / switch / show
    gate("encode", lambda: same_bytes(
        os.path.join(sets["encode"][0], "encoded", "part-00000"),
        os.path.join(sets["encode"][1], "encoded", "part-00000"),
        "encode part-00000"))
    manage = manage_round_trip(pmml_src["gbt"], os.path.join(w13, "mg"))
    print("  encode part-00000 card vs CPU; new/save/switch/show restore "
          "the saved tree")
    assert not failed, "phase 13 gates failed:\n" + "\n".join(failed)

    report["level_hist"]["launches"] += fi["counters"][0]
    report["best_splits"]["launches"] += fi["counters"][1]
    report["fused_score"]["launches"] += launched["fused_score"]
    report["fused_trees"]["launches"] += launched["fused_trees"]
    timed = {"se_65536x600_s": se_line["seconds"],
             "v_s": v_line["seconds"],
             "fi_rf_s": fi["line"]["seconds"],
             "correlation_s": lines[f"stats -correlation hig"][0]["seconds"],
             "baggingpmml_s":
                 lines["export -t baggingpmml pmml_nn_card"][0]["seconds"],
             "encode_s": lines["encode encode_card"][0]["seconds"]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() if device == "cuda" else "cpu"
    print(f"  phase 13 card seconds (beside the CPU twin) on {smi}: "
          + json.dumps(timed))
    report["varselect_export"] = {
        "rows": rows, "raw_bytes": raw_bytes, "setup_s": setup_s,
        "errors": errs, "pmml": pm, "fi": {k: v for k, v in fi.items()
                                           if k != "line"},
        "seconds": timed, "manage": manage, "convert": conv,
        "total_s": time.perf_counter() - t0}


def _pf_path(root, what):
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.config.path_finder import PathFinder
    return getattr(PathFinder(ModelConfig.load(root), root=root), what)()


def varselect_walls(rows=VS_ROWS, se_rows=NN_EVAL_ROWS, reps=2):
    """Phase 13's card timings, each step a process with the host to
    itself, `reps` times: `stats -correlation` at `rows` × 30, `varsel`
    FI (the RF, 10 trees), `encode` of that RF, SE at `se_rows` × 600
    (the 64-unit quick NN) and `export -t baggingpmml` of a 2-bag wide
    NN (600 → 512 → 256 → 1, weights from seeds). Returns each step's
    lines."""
    from shifu_tpu_torch.models.spec import save_model
    out = {}
    with tempfile.TemporaryDirectory() as w:
        hig = os.path.join(w, "hig")
        vs_model_set(hig, rows)
        run_step(hig, "init")
        run_step(hig, "stats", "cuda")
        fi = copy_config(hig, os.path.join(w, "fi"))
        set_config(fi, "varSelect", filterBy="FI")
        nn = os.path.join(w, "nn")
        names, tokens = nn_raw_table(np.random.default_rng(81), se_rows)
        nn_model_set(nn, names, tokens, 82)
        for bag in range(2):   # the 2-bag wide NN, its inputs named
            save_model(os.path.join(nn, "models", f"model{bag}.nn"), "nn",
                       {"spec": {"input_dim": NN_IN,
                                 "hidden_dims": list(NN_HIDDEN),
                                 "activations": ["relu", "relu"]},
                        "inputNames": names[:NN_IN]},
                       nn_params(np.random.default_rng(82 + bag)))
        se = copy_config(nn, os.path.join(w, "se"))
        set_config(se, "train", **SE_TRAIN)
        set_config(se, "varSelect", filterBy="SE", filterNum=300)
        enc = os.path.join(w, "enc")
        steps = {"correlation": (hig, ["stats", "-correlation"]),
                 "fi_rf": (fi, ["varsel"]), "encode": (enc, ["encode"]),
                 "se": (se, ["varsel"]),
                 "baggingpmml": (nn, ["export", "-t", "baggingpmml"])}
        for rep in range(reps):
            for name, (root, verb) in steps.items():
                if name == "encode" and not os.path.exists(enc):
                    # FI leaves 15 columns selected, fewer than its RF
                    # reads: encode the RF over every candidate
                    model_copy(fi, enc)
                    run_step(enc, ["varsel", "-reset"], "cuda")
                line = run_step(root, verb, "cuda")
                out.setdefault(name, []).append(
                    {k: line.get(k) for k in ("rows", "seconds", "device",
                                              "launches", "columns")
                     if k in line})
                print(f"  varselect walls {name} {rep + 1}: "
                      + json.dumps(out[name][-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"card": smi, "rows": rows, "se_rows": se_rows, "steps": out}


# ---------------------------------------------------------------------------
# Phase 14: WDL, MTL and train#trainOnDisk
# ---------------------------------------------------------------------------

P14_ROWS = 32_768           # the WDL/MTL sets: card against the CPU twin
P14_HOLDOUT = 8_192         # their eval sets
P14_STREAM_ROWS = 65_536    # phase 14 (c)'s HIGGS table (no weight column)
# bench.py:96-108 and :110-119 (rows, short and long epochs for the walls)
WDL_DENSE, WDL_CAT, WDL_VOCAB, WDL_EMBED = 13, 26, 10_000, 16
WDL_HIDDEN = (256, 128)
MTL_FEATURES, MTL_TASKS, MTL_HIDDEN = 64, 4, (128, 64)
P14_WALL_ROWS, P14_WALL_EPOCHS = 500_000, (2, 22)
STREAM_WALL_CHUNK = 262_144  # build_gbt_streaming at 2,000,000 × 28


def wdl_raw_table(rng, rows, dense=WDL_DENSE, cat=WDL_CAT, vocab=WDL_VOCAB):
    """The Criteo-like table: `dense` numeric columns and `cat`
    categorical ones whose ids are drawn Zipf over `vocab` values (2 %
    and 1 % missing), a label from a few dense columns and one effect a
    category of the first four categorical columns."""
    x = rng.normal(0, 1, (rows, dense)).astype(np.float32)
    ids = (rng.zipf(1.2, (rows, cat)) - 1) % vocab
    effect = np.random.default_rng(90).normal(0, 0.8, (4, vocab))
    logit = x[:, 0] - 0.6 * x[:, 1] + 0.4 * x[:, 2] \
        + sum(effect[j, ids[:, j]] for j in range(4)) \
        + rng.logistic(0, 1, rows)
    x[rng.random(x.shape) < 0.02] = np.nan
    text = np.where(np.isnan(x), "?", x.astype(str))
    cats = np.char.add("v", ids.astype(str))
    cats[rng.random(cats.shape) < 0.01] = "?"
    names = [f"d{j}" for j in range(dense)] + [f"c{j}" for j in range(cat)] \
        + ["label"]
    label = np.where(logit > 0, "1", "0")
    return names, np.concatenate([text, cats, label[:, None]], axis=1)


def mtl_raw_table(rng, rows, c=MTL_FEATURES, tasks=MTL_TASKS):
    """`c` numeric columns (2 % missing) and `tasks` tag columns t0…,
    each from its own noisy projection; tasks 1… lack a tag on 10 % of
    the rows (task 0 always has one: norm keeps rows by it)."""
    x = rng.normal(0, 1, (rows, c)).astype(np.float32)
    beta = np.random.default_rng(91).normal(0, 1, (c, tasks))
    score = x @ beta / np.sqrt(c) * 2 + rng.logistic(0, 1, (rows, tasks))
    tags = np.where(score > 0, "1", "0")
    tags[:, 1:][rng.random((rows, tasks - 1)) < 0.1] = "?"
    x[rng.random(x.shape) < 0.02] = np.nan
    text = np.where(np.isnan(x), "?", x.astype(str))
    names = [f"f{j}" for j in range(c)] + [f"t{k}" for k in range(tasks)]
    return names, np.concatenate([text, tags], axis=1)


def p14_model_set(root, workdir, kind, device="cuda", rows=None):
    """Phase 14's WDL or MTL model set: raw table and holdout (eval set
    `Eval1`) from seeds, `init → stats → norm` on the card (ZSCALE_INDEX
    for WDL, ZSCALE for MTL)."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fileio import atomic_write
    table = wdl_raw_table if kind == "WDL" else mtl_raw_table
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, *table(np.random.default_rng(92), rows or P14_ROWS))
    holdout = os.path.join(workdir, f"{kind.lower()}_holdout")
    write_raw(holdout, *table(np.random.default_rng(93), P14_HOLDOUT))
    target = "label" if kind == "WDL" else \
        "|".join(f"t{k}" for k in range(MTL_TASKS))
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": target, "posTags": ["1"],
                "negTags": ["0"]}
    if kind == "WDL":
        cols_dir = os.path.join(root, "columns")
        os.makedirs(cols_dir)
        path = os.path.join(cols_dir, "categorical.column.names")
        with atomic_write(path) as f:
            f.write("".join(f"c{j}\n" for j in range(WDL_CAT)))
        data_set["categoricalColumnNameFile"] = path
    else:
        cols_dir = os.path.join(root, "columns")
        os.makedirs(cols_dir)
        path = os.path.join(cols_dir, "meta.column.names")
        with atomic_write(path) as f:
            f.write("".join(f"t{k}\n" for k in range(1, MTL_TASKS)))
        data_set["metaColumnNameFile"] = path
    ModelConfig.from_dict({
        "basic": {"name": f"smoke{kind}"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE_INDEX" if kind == "WDL"
                      else "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": p14_train_fields(kind),
        "evals": [{"name": "Eval1", "dataSet": dict(
            data_set, dataPath=holdout,
            headerPath=os.path.join(holdout, ".pig_header"))}]}).save(root)
    return run_pipeline(root, device, norms=(
        "ZSCALE_INDEX" if kind == "WDL" else "ZSCALE",))


def p14_train_fields(kind, epochs=6, **params):
    """`train` of phase 14's sets: WDL (bench.py's embed 16, deep 256 →
    128, relu) or MTL (128 → 64, relu), ADAM, 2 Poisson bags, 10 %
    validation."""
    hidden = WDL_HIDDEN if kind == "WDL" else MTL_HIDDEN
    params.update(Propagation="ADAM", LearningRate=0.002,
                  NumHiddenNodes=list(hidden),
                  ActivationFunc=["relu"] * len(hidden))
    if kind == "WDL":
        params["EmbedSize"] = WDL_EMBED
    return {"algorithm": kind, "numTrainEpochs": epochs, "baggingNum": 2,
            "baggingWithReplacement": True, "baggingSampleRate": 1.0,
            "validSetRate": 0.1, "params": params}


def copy_tmp(src, dst):
    """`copy_config` plus all of `src`'s tmp/ (both data layouts)."""
    import shutil
    copy_config(src, dst)
    shutil.copytree(os.path.join(src, "tmp"), os.path.join(dst, "tmp"))
    return dst


def copy_models(src, dst):
    """`copy_config` plus `src`'s models/: a twin that scores the very
    model files `src` trained."""
    import shutil
    copy_config(src, dst)
    shutil.copytree(os.path.join(src, "models"),
                    os.path.join(dst, "models"))
    return dst


def compare_layout(card_root, cpu_root):
    """Every `.npy` block and meta.json of both streaming layouts (card
    `norm` against CPU `norm`): equal to the bit. Returns the files
    compared."""
    n = 0
    for sub in ("NormalizedData", "CleanedData"):
        da = os.path.join(card_root, "tmp", sub)
        db = os.path.join(cpu_root, "tmp", sub)
        names = sorted(f for f in os.listdir(db) if f.endswith(".npy"))
        assert sorted(f for f in os.listdir(da) if f.endswith(".npy")) \
            == names and "dense.npy" in names, (sub, names)
        for name in names:
            a, b = np.load(os.path.join(da, name)), np.load(
                os.path.join(db, name))
            assert a.dtype == b.dtype and a.shape == b.shape, (sub, name)
            assert a.tobytes() == b.tobytes(), \
                f"{sub}/{name} differs card vs CPU"
            n += 1
        with open(os.path.join(da, "meta.json")) as f:
            ma = json.load(f)
        with open(os.path.join(db, "meta.json")) as f:
            assert json.load(f) == ma and ma["streaming"], sub
    return n


def p14_serve(root, blocks, tol, device="cuda"):
    """The card's `ScorerService` behind `HttpFrontEnd` serves `root`'s
    models; 512 rows in process and 64 over `POST /score`, each held
    against a CPU service."""
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    from shifu_tpu_torch.serve.service import ScorerService
    models = os.path.join(root, "models")
    gpu = ScorerService(models_dir=models, max_delay=0.002, device=device)
    cpu = ScorerService(models_dir=models, max_delay=0.002, device="cpu")
    front = None
    try:
        gpu.start()
        cpu.start()
        front = HttpFrontEnd(gpu, host="127.0.0.1", port=0).start()
        rows = {k: v[:512] for k, v in blocks.items()}
        got, want = gpu.submit(**rows), cpu.submit(**rows)
        worst = 0.0
        for k in want:
            assert got[k].shape == (512,) and np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
            worst = max(worst, float(np.abs(got[k] - want[k]).max()))
        small = {k: v[:64] for k, v in blocks.items()}
        over_http = _post("http://%s:%d" % front.address, small)
        want = cpu.submit(**small)
        for k in want:
            np.testing.assert_allclose(np.asarray(over_http[k], np.float64),
                                       want[k], **tol, err_msg=f"http {k}")
        return {"max_abs_err": worst, "models": gpu.stats()["models"]}
    finally:
        if front is not None:
            front.close()
        gpu.close()
        cpu.close()


def p14_family(kind, workdir, device="cuda"):
    """Phase 14 (a) or (b): the set through the port's pipeline on the
    card; `train` on the card and with `--device cpu` from the same
    matrix (each bag's best validation error within 1e-4 relative);
    `eval` and `posttrain` of the card-trained models on the card and
    on a CPU twin (scores within 1e-5; importance 1e-4, binAvgScore
    1e-5 relative); `serve` of them (within 1e-5)."""
    base = os.path.join(workdir, kind.lower())
    steps = p14_model_set(base, workdir, kind, device)
    card = copy_normalized(base, base + "_card")
    cpu = copy_normalized(base, base + "_cpu")
    t_card, t_cpu = run_twins(card, cpu, "train", device)
    assert t_card["device"].startswith(device) and t_card["bags"] == 2
    train_errs = compare_training(t_card, t_cpu, card, cpu, best_rel=1e-4)
    twin = copy_models(card, card + "_twin")
    e_card, e_cpu = run_twins(card, twin, "eval", device)
    eval_errs = compare_eval_dir(card, twin, "Eval1", 1e-5)
    p_card, p_cpu = run_twins(card, twin, "posttrain", device)
    post_errs = compare_posttrain(card, twin, 1e-4, 1e-5)
    data = np.load(os.path.join(base, "tmp", "NormalizedData", "data.npz"))
    blocks = {"dense": data["dense"].astype(np.float32)}
    if kind == "WDL":
        blocks["index"] = data["index"].astype(np.int32)
    served = p14_serve(card, blocks, dict(rtol=1e-5, atol=1e-5), device)
    return {"pipeline": steps, "train": {"card": t_card, "cpu": t_cpu},
            "train_errors": train_errs,
            "eval": {"card": e_card, "cpu": e_cpu, "errors": eval_errs},
            "posttrain": {"card": p_card, "cpu": p_cpu,
                          "errors": post_errs},
            "serve": served}


def disk_layout(src, dst, device="cuda"):
    """Phase 14 (c)'s `norm` with trainOnDisk on a copy of `src`'s
    configs, on the card and with `--device cpu`: their `.npy` files
    must be equal to the bit. Returns (card root, CPU root, the two
    norm lines, the files compared)."""
    card = copy_config(src, dst)
    cpu = copy_config(src, dst + "_cpu")
    for root in (card, cpu):
        set_config(root, "train", trainOnDisk=True)
    norm = run_twins(card, cpu, "norm", device)
    return card, cpu, norm, compare_layout(card, cpu)


def higgs_layout(workdir, device="cuda"):
    """The HIGGS table of phase 14 (c) (phase 8's widths, no weight
    column, 65,536 rows): `init` and `stats` on the card, then
    `disk_layout`."""
    hig = os.path.join(workdir, "stream_hig")
    write_model_set(hig, "GBT", {}, 94, P14_STREAM_ROWS, 0.1)
    run_step(hig, "init")
    run_step(hig, "stats", device)
    return disk_layout(hig, os.path.join(workdir, "disk_higgs"), device)


P14_STREAM_TRAIN = {
    # name: (layout, train section); ChunkRows gives ≥ 4 chunks
    "NN": ("higgs", {"algorithm": "NN", "numTrainEpochs": 8,
                     "baggingNum": 2, "baggingWithReplacement": True,
                     "baggingSampleRate": 1.0, "validSetRate": 0.1,
                     "params": {"NumHiddenLayers": 1,
                                "NumHiddenNodes": [64],
                                "ActivationFunc": ["tanh"],
                                "Propagation": "ADAM", "LearningRate": 0.005,
                                "ChunkRows": 12_000}}),
    "WDL": ("wdl", dict(p14_train_fields("WDL", epochs=6, ChunkRows=6_000))),
    "MTL": ("mtl", dict(p14_train_fields("MTL", epochs=6, ChunkRows=6_000))),
    "GBT": ("higgs", {"algorithm": "GBT", "validSetRate": 0.1, "params": {
        "TreeNum": 5, "MaxDepth": TRAIN_DEPTH, "LearningRate": TRAIN_LR,
        "Loss": "log", "ChunkRows": 12_000}}),
    "RF": ("higgs", {"algorithm": "RF", "validSetRate": 0.0, "params": {
        "TreeNum": 5, "MaxDepth": TRAIN_DEPTH,
        "FeatureSubsetStrategy": "SQRT", "ChunkRows": 12_000}}),
}


def stream_trains(workdir, layouts, device="cuda"):
    """Phase 14 (c)'s streaming `train` runs, each on the card (from the
    card's layout) and with `--device cpu` (from the CPU's): NN, WDL and
    MTL (best validation errors within 1e-4 relative), GBT on both
    row-state tiers (train log-loss within 1e-4 relative, AUC 1e-3, as
    phase 8 holds log-loss GBT) and RF (model files equal to the bit);
    the device-tier GBT then trains a second time on the card (phase 14
    (d)). Three lanes, each a card run beside its CPU twin at a time:
    more at once oversubscribe the host's cores. Returns {run: (card
    line, CPU line, card root, CPU root)}."""
    jobs = {}
    for name, (layout, fields) in P14_STREAM_TRAIN.items():
        for tier in (("1", "0") if name == "GBT" else (None,)):
            run = name if tier is None else f"GBT tier {tier}"
            key = run.replace(" ", "_")
            card = copy_tmp(layouts[layout][0],
                            os.path.join(workdir, f"st_{key}"))
            cpu = copy_tmp(layouts[layout][1],
                           os.path.join(workdir, f"st_{key}_cpu"))
            for root in (card, cpu):
                set_config(root, "train", **fields)
            jobs[run] = (card, cpu, tier)

    def one(run):
        card, cpu, tier = jobs[run]
        env = None if tier is None else \
            {"SHIFU_TPU_GBT_RESIDENT_STATE": tier}
        cpu_proc = _start_step(cpu, "train", "cpu",
                               dict(CPU_TWIN_ENV, **(env or {})))
        card_line, (cpu_line,) = beside(
            [(cpu_proc, f"train --device cpu on {cpu}")],
            lambda: run_step(card, "train", device, env))
        out = [(run, (card_line, cpu_line, card, cpu))]
        if run == "GBT tier 1":
            again = copy_tmp(card, os.path.join(workdir, "st_GBT_again"))
            out.append(("GBT tier 1, again", (
                run_step(again, "train", device, env), None, again, None)))
        return out
    lanes = (("NN", "GBT tier 1"), ("WDL", "GBT tier 0"), ("MTL", "RF"))
    done = in_parallel(*[lambda lane=lane: [r for run in lane
                                            for r in one(run)]
                         for lane in lanes])
    return dict(r for lane in done for r in lane)


def check_stream_trains(runs, device="cuda"):
    """The gates of `stream_trains`; returns the differences."""
    out = {}
    for run, (card, cpu, card_root, cpu_root) in runs.items():
        assert card["device"].startswith(device), run
        if cpu is None:
            continue
        if run in ("NN", "WDL", "MTL"):
            out[run] = compare_training(card, cpu, card_root, cpu_root,
                                        best_rel=1e-4)
        elif run == "RF":
            _, ma, pa = _model_file(card_root, "rf")
            _, mb, pb = _model_file(cpu_root, "rf")
            assert ma == mb
            for part in ("trees", "tables"):
                for k in pb[part]:
                    assert np.array_equal(pa[part][k], pb[part][k]), \
                        f"streaming RF {part}.{k} differs card vs CPU"
            out[run] = {"bit_exact": True}
        else:
            clean = np.load(os.path.join(cpu_root, "tmp", "CleanedData",
                                         "data.npz"))
            x, y = clean["dense"], clean["tags"]
            ref = train_metrics(cpu_root, x, y)
            loss, a = train_metrics(card_root, x, y)
            assert abs(loss - ref[0]) <= 1e-4 * ref[0], \
                f"{run}: train log-loss {loss} vs CPU {ref[0]}"
            assert abs(a - ref[1]) <= 1e-3, f"{run}: AUC {a} vs {ref[1]}"
            out[run] = {"log_loss": [loss, ref[0]], "auc": [a, ref[1]]}
        launches = card.get("launches", {})
        if run in ("GBT tier 1", "GBT tier 0", "RF"):
            assert launches["level_hist"] > 0 and \
                launches["best_splits"] > 0, f"{run}: {launches}"
    return out


def same_model_members(a, b):
    """Whether two model files hold the same bytes in every member (the
    npz container's member timestamps aside)."""
    import zipfile
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        names = sorted(za.namelist())
        return names == sorted(zb.namelist()) and all(
            za.read(n) == zb.read(n) for n in names)


def atomics_check(runs, workdir, device="cuda"):
    """Phase 14 (d), a gate: K3/K4 add in fixed point, so two card runs
    of one model set write the same model. The streaming log-loss GBT
    (device tier) trained twice, and the same set trained resident
    (`build_gbt` over CleanedData/data.npz) twice: every member of each
    pair of model files equal to the byte. Returns the resident runs'
    card lines and the sizes compared."""
    lines = []
    pairs = {"streaming": (runs["GBT tier 1"][2],
                           runs["GBT tier 1, again"][2])}
    resident = []
    for k in ("a", "b"):
        root = copy_tmp(runs["GBT tier 1"][2],
                        os.path.join(workdir, f"resident_gbt_{k}"))
        set_config(root, "train", trainOnDisk=False)
        lines.append(run_step(root, "train", device))
        assert lines[-1]["launches"]["level_hist"] > 0, lines[-1]
        resident.append(root)
    pairs["resident"] = tuple(resident)
    out = {}
    for name, (a, b) in pairs.items():
        pa, pb = (os.path.join(r, "models", "model0.gbt") for r in (a, b))
        assert same_model_members(pa, pb), \
            f"two card runs of the {name} log-loss GBT wrote different models"
        out[name] = {"equal": True, "bytes": os.path.getsize(pa)}
    return out, lines


def phase_wdl_mtl_stream(report, workdir, device="cuda"):
    """Phase 14: WDL and MTL at the bench.py widths trained, evaluated,
    post-trained and served on the card against the CPU twin; the
    trainOnDisk layouts and streaming trainers card against CPU; the
    K3/K5 launches of the streaming builders (`p14_walls`); two card
    runs of the streaming log-loss GBT."""
    t0 = time.perf_counter()
    # the launch gate (`p14_launches`) runs in a process of its own
    # beside the rest of the phase: a process that has traced earlier
    # phases loses profiler records, and the profiler traces its own
    # process's kernels only
    gate = background_start(os.path.join(workdir, "p14_launches"),
                            "--p14-launches", device)
    try:
        p14_phase_body(report, workdir, device, t0)
        report["phase14"]["stream_launches"] = background_finish(
            gate, "--p14-launches")["p14_launches"]
    finally:
        background_stop(gate)
    report["phase14"]["seconds"] = time.perf_counter() - t0
    print(f"  phase 14: families {report['phase14']['family_s']:.1f} s, "
          f"streaming {report['phase14']['stream_s']:.1f} s, the launch "
          f"gate's process beside them; {report['phase14']['seconds']:.1f}"
          " s")


def p14_phase_body(report, workdir, device, t0):
    """Phase 14 but its launch gate: the families, the layouts, the
    streaming trainers and the atomics check."""
    wdl, mtl, higgs = in_parallel(
        lambda: p14_family("WDL", workdir, device),
        lambda: p14_family("MTL", workdir, device),
        lambda: higgs_layout(workdir, device))
    fam = {"WDL": wdl, "MTL": mtl}
    for kind, r in fam.items():
        print(f"  {kind} pipeline: {json.dumps(r['pipeline'])}")
        print(f"  {kind} train card = CPU: {json.dumps(r['train_errors'])}"
              f" (card {r['train']['card']['seconds']:.2f} s, CPU "
              f"{r['train']['cpu']['seconds']:.2f} s)")
        print(f"  {kind} eval card = CPU: {json.dumps(r['eval']['errors'])}")
        print(f"  {kind} posttrain card = CPU: "
              f"{json.dumps(r['posttrain']['errors'])}")
        print(f"  {kind} serve: {json.dumps(r['serve'])}")
    t_fam = time.perf_counter() - t0
    layouts = dict(zip(("higgs", "wdl", "mtl"), [higgs] + in_parallel(
        *[lambda k=k: disk_layout(os.path.join(workdir, k),
                                  os.path.join(workdir, f"disk_{k}"), device)
          for k in ("wdl", "mtl")])))
    for name, (_, _, norm, n) in layouts.items():
        print(f"  trainOnDisk norm {name}: {n} .npy files equal to the bit "
              f"(card {norm[0]['seconds']:.2f} s, CPU "
              f"{norm[1]['seconds']:.2f} s)")
    runs = stream_trains(workdir, layouts, device)
    for run, (card, cpu, _, _) in runs.items():
        print(f"  streaming train {run}: card {card['seconds']:.2f} s "
              f"launches {card['launches']}"
              + (f", CPU {cpu['seconds']:.2f} s" if cpu else ""))
    gates = check_stream_trains(runs, device)
    print(f"  streaming card = CPU: {json.dumps(gates)}")
    for run in ("GBT tier 1", "GBT tier 0", "RF", "GBT tier 1, again"):
        for k in ("level_hist", "best_splits"):
            report[k]["launches"] += runs[run][0]["launches"][k]
    atomics, resident = atomics_check(runs, workdir, device)
    for line in resident:
        for k in ("level_hist", "best_splits"):
            report[k]["launches"] += line["launches"][k]
    print(f"  two card runs each of the streaming and the resident log-loss "
          f"GBT write equal models: {json.dumps(atomics)}")
    t_stream = time.perf_counter() - t0 - t_fam
    report["phase14"] = {
        "families": fam, "family_s": t_fam, "stream_s": t_stream,
        "layouts": {k: v[2:] for k, v in layouts.items()},
        "stream": {k: v[:2] for k, v in runs.items()},
        "stream_gates": gates, "atomics": atomics}


def family_walls(kind, device="cuda", rows=P14_WALL_ROWS,
                 epochs=P14_WALL_EPOCHS):
    """WDL or MTL at the bench.py widths on the card: `trainer.
    train_bags` as `processor/train_wdl` calls it (1 bag, ADAM, 5 %
    validation, rows from a seed), at a short and a long epoch count
    (`bench.py`'s two-length method): row·epochs/s and ms an epoch;
    launches an epoch between marker kernels and the idle share over
    five profiled epochs of the epoch loop on inputs already on the
    card; whether five epochs run under
    `torch.cuda.set_sync_debug_mode("error")`."""
    import torch
    from shifu_tpu_torch.models import mtl, wdl
    from shifu_tpu_torch.train import trainer
    from shifu_tpu_torch.train.optimizers import optimizer_from_params
    rng = np.random.default_rng(95)
    params = {"Propagation": "ADAM", "LearningRate": 0.002}
    if kind == "WDL":
        dense = rng.standard_normal((rows, WDL_DENSE), dtype=np.float32)
        idx = ((rng.zipf(1.2, (rows, WDL_CAT)) - 1)
               % WDL_VOCAB).astype(np.int32)
        y = (dense[:, 0] - 0.5 * dense[:, 1] + (idx[:, 0] % 3 == 0)
             + rng.standard_normal(rows) > 0.5).astype(np.float32)
        spec = wdl.WDLSpec(dense_dim=WDL_DENSE, n_cat=WDL_CAT,
                           vocab_size=WDL_VOCAB + 1, embed_size=WDL_EMBED,
                           hidden_dims=WDL_HIDDEN,
                           activations=("relu",) * len(WDL_HIDDEN))
        inputs = (dense, idx, y)
        init = wdl.init_params

        def loss(p, i, w_, g):
            return wdl.loss_fn(spec, p, *i, w_)

        def metric(p, i, w_):
            return wdl.mse(spec, p, *i, w_)
        flops_row = _flops_per_row(spec.deep_spec.layer_dims)
    else:
        x = rng.standard_normal((rows, MTL_FEATURES), dtype=np.float32)
        beta = rng.standard_normal((MTL_FEATURES, MTL_TASKS))
        y = (x @ beta + rng.standard_normal((rows, MTL_TASKS))
             > 0).astype(np.float32)
        y[:, 1:][rng.random((rows, MTL_TASKS - 1)) < 0.1] = np.nan
        spec = mtl.MTLSpec(input_dim=MTL_FEATURES, n_tasks=MTL_TASKS,
                           hidden_dims=MTL_HIDDEN,
                           activations=("relu",) * len(MTL_HIDDEN))
        inputs = (x, y)
        init = mtl.init_params

        def loss(p, i, w_, g):
            return mtl.loss_fn(spec, p, *i, w_)

        def metric(p, i, w_):
            return mtl.mse(spec, p, *i, w_)
        flops_row = _flops_per_row([MTL_FEATURES, *MTL_HIDDEN, MTL_TASKS])
    tr, va = trainer.split_validation(rows, 0.05, 1)
    n_train = int(tr.sum())
    opt = optimizer_from_params(params)
    walls = {}
    for n_ep in (epochs[0], epochs[0], epochs[1]):   # the first warms up
        stacked = trainer.initial_params(lambda g: init(spec, g), 1, 1)
        mask = trainer.tree_map(lambda v: torch.ones_like(v[0]), stacked)
        t0 = time.perf_counter()
        trainer.train_bags(loss, metric, opt, n_ep, 0, 0.0, stacked,
                           tuple(a[tr] for a in inputs),
                           np.ones((1, n_train), np.float32),
                           tuple(a[va] for a in inputs),
                           np.ones(int(va.sum()), np.float32), mask,
                           device=device)
        walls[n_ep] = time.perf_counter() - t0
    d_wall = walls[epochs[1]] - walls[epochs[0]]
    d_epochs = epochs[1] - epochs[0]

    dev = torch.device(device)
    placed = tuple(torch.as_tensor(a[tr]).to(dev) for a in inputs)
    vplaced = tuple(torch.as_tensor(a[va]).to(dev) for a in inputs)
    wt = torch.ones((1, n_train), device=dev)
    wv = torch.ones(int(va.sum()), device=dev)
    stacked = trainer.tree_map(lambda v: v.to(dev), trainer.initial_params(
        lambda g: init(spec, g), 1, 1))
    mask = trainer.tree_map(lambda v: torch.ones_like(v[0]), stacked)

    def run(n):
        carry = trainer.init_train_carry(opt, stacked)
        return trainer.train_bags_carry(loss, metric, opt, n, 0, 0.0, carry,
                                        placed, wt, vplaced, wv, mask)
    run(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(5)
        sync_free = True
    except RuntimeError:
        sync_free = False
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    one = len(kernels_between_markers(lambda: run(1)))
    three = len(kernels_between_markers(lambda: run(3)))
    wall_ms, dev_ms = device_busy(lambda: run(5))
    out = {"rows": rows, "train_rows": n_train, "epochs": list(epochs),
           "wall_s": {str(k): v for k, v in walls.items()},
           "row_epochs_per_s": n_train * d_epochs / d_wall,
           "ms_per_epoch": d_wall / d_epochs * 1e3,
           "f32_peak_share_dense_layers": flops_row * n_train * d_epochs
           / d_wall / F32_PEAK,
           "launches_per_epoch": (three - one) / 2,
           "profiled_5_epochs_ms": wall_ms, "device_ms": dev_ms,
           "idle_share": 1 - dev_ms / wall_ms, "sync_free_5_epochs": sync_free}
    print(f"  p14 {kind} walls: " + json.dumps(out))
    del placed, vplaced
    torch.cuda.empty_cache()
    return out


def stream_launches(device="cuda", rows=P14_STREAM_ROWS, chunks=4):
    """K3 and K5 launches of one depth-6 streaming tree between marker
    kernels, against §2's prediction: K3 7 a chunk and K5 6 a tree on
    either row-state tier over `chunks` chunks, and K3 7, K5 6 on the
    resident-state tier with one chunk (the resident builder's count).
    Every count must equal the prediction."""
    import torch
    from shifu_tpu_torch.models import gbdt
    rng = np.random.default_rng(96)
    bins = rng.integers(0, GBT_BINS, (rows, GBT_COLS)).astype(np.uint8)
    y = (bins[:, 0].astype(np.float32) + rng.normal(0, 8, rows)
         > GBT_BINS / 2).astype(np.float32)
    w = np.ones(rows, np.float32)
    path = os.path.join(tempfile.mkdtemp(), "bins.npy")
    np.save(path, bins)
    mm = np.load(path, mmap_mode="r")
    cfg = gbdt.TreeConfig(max_depth=TRAIN_DEPTH, n_bins=GBT_BINS,
                          learning_rate=TRAIN_LR, loss="log")
    out = {}
    for tier, n_chunks in (("0", chunks), ("1", chunks), ("1", 1)):
        os.environ["SHIFU_TPU_GBT_RESIDENT_STATE"] = tier
        chunk_rows = -(-rows // n_chunks)
        gbdt.build_gbt_streaming(cfg, mm, y, w, 1, chunk_rows=chunk_rows)
        names = kernels_between_markers(lambda: gbdt.build_gbt_streaming(
            cfg, mm, y, w, 1, chunk_rows=chunk_rows))
        got = {"K3": count_kernels(names, "level_hist"),
               "K5": count_kernels(names, "best_splits")}
        want = {"K3": (TRAIN_DEPTH + 1) * n_chunks, "K5": TRAIN_DEPTH}
        key = f"tier {tier}, {n_chunks} chunks"
        assert got == want, f"{key}: launches {got}, predicted {want}"
        out[key] = got
    os.environ.pop("SHIFU_TPU_GBT_RESIDENT_STATE")
    torch.cuda.synchronize()
    return out


def stream_walls(repeats=2):
    """`build_gbt_streaming` at 2,000,000 × 28 (ChunkRows 262,144, both
    row-state tiers) against the resident `build_gbt` at the same shape,
    log loss, 10 trees, on the card alone: wall seconds after a one-tree
    warm-up."""
    import torch
    from shifu_tpu_torch.models import gbdt
    cfg = gbdt.TreeConfig(max_depth=TRAIN_DEPTH, n_bins=GBT_BINS,
                          learning_rate=TRAIN_LR, loss="log")
    _, binsT, _, y = _gbt_data(HIGGS_ROWS, "cuda")
    w = torch.ones_like(y)
    path = os.path.join(tempfile.mkdtemp(), "bins.npy")
    np.save(path, binsT.cpu().numpy().T.astype(np.uint8))
    mm = np.load(path, mmap_mode="r")
    y_h, w_h = y.cpu().numpy(), w.cpu().numpy()
    def streaming(tier):
        def fn(n):
            os.environ["SHIFU_TPU_GBT_RESIDENT_STATE"] = tier
            return gbdt.build_gbt_streaming(cfg, mm, y_h, w_h, n,
                                            chunk_rows=STREAM_WALL_CHUNK)
        return fn
    runs = {"resident build_gbt": lambda n: gbdt.build_gbt(cfg, binsT, y, w,
                                                           n),
            "streaming tier 1": streaming("1"),
            "streaming tier 0": streaming("0")}
    out = {}
    for name, fn in runs.items():
        fn(1)
        out[name] = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(HIGGS_TREES)
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    os.environ.pop("SHIFU_TPU_GBT_RESIDENT_STATE", None)
    out["chunks"] = -(-HIGGS_ROWS // STREAM_WALL_CHUNK)
    print("  p14 streaming walls: " + json.dumps(out))
    return out


def p14_launches():
    out = {"launches": stream_launches()}
    print("  p14 streaming launches: " + json.dumps(out["launches"]))
    return out


def p14_walls():
    out = p14_launches()
    out["wdl"] = family_walls("WDL")
    out["mtl"] = family_walls("MTL")
    out["stream"] = stream_walls()
    return out


# ---------------------------------------------------------------------------
# phase 15: the verbs past their size triggers (the streaming steps)
# ---------------------------------------------------------------------------

P15_ROWS = 131_072          # phase 10's table, with phase 13's cohorts
P15_CHUNK = 32_768          # 8 chunks a pass
P15_MC_ROWS = 32_768        # the 3-class table scored in chunks
P15_ENV = {f"SHIFU_TPU_{k}_CHUNK_ROWS": str(P15_CHUNK)
           for k in ("STATS", "NORM", "EVAL", "ANALYSIS")}
P15_TREES = {
    "GBT": {"TreeNum": 5, "MaxDepth": TRAIN_DEPTH, "LearningRate": TRAIN_LR,
            "Loss": "log", "ChunkRows": P15_CHUNK},
    "RF": {"TreeNum": 5, "MaxDepth": TRAIN_DEPTH,
           "FeatureSubsetStrategy": "SQRT", "ChunkRows": P15_CHUNK}}
# ColumnConfig fields of the streaming stats that come from float64 sums
STREAM_FLOATS = {"mean", "stdDev", "skewness", "kurtosis", "min", "max",
                 "median", "p25th", "p75th", "missingPercentage", "ks", "iv",
                 "woe", "weightedKs", "weightedIv", "weightedWoe",
                 "binWeightedPos", "binWeightedNeg", "binPosRate",
                 "binCountWoe", "binWeightedWoe"}


def compare_streaming_configs(card_root, cpu_root, rtol=1e-9):
    """ColumnConfig.json of the streaming stats, card against CPU: every
    field equal (bin boundaries and counts included) but those of
    `STREAM_FLOATS`, float64 sums and what derives from them, within
    `rtol` (an absolute 1e-9 near zero). Returns the largest relative
    difference."""
    card, cpu = column_configs(card_root), column_configs(cpu_root)
    assert [c["columnName"] for c in card] == [c["columnName"] for c in cpu]
    worst, bad = 0.0, []
    for a, b in zip(card, cpu):
        fields = {**a["columnStats"], **a["columnBinning"],
                  **{k: v for k, v in a.items()
                     if k not in ("columnStats", "columnBinning")}}
        ref = {**b["columnStats"], **b["columnBinning"],
               **{k: v for k, v in b.items()
                  if k not in ("columnStats", "columnBinning")}}
        for k, v in fields.items():
            w = ref[k]
            if k in STREAM_FLOATS and v is not None and w is not None:
                va, vb = np.asarray(v, float), np.asarray(w, float)
                if va.size:
                    worst = max(worst, float(np.nanmax(
                        np.abs(va - vb) / np.maximum(np.abs(vb), 1e-9))))
                if not np.allclose(va, vb, rtol=rtol, atol=1e-9,
                                   equal_nan=True):
                    bad.append(f"{a['columnName']}.{k}: {v} vs {w}")
            elif v != w:
                bad.append(f"{a['columnName']}.{k}: {v} vs {w}")
    assert not bad, "streaming ColumnConfig.json card vs CPU:\n" + \
        "\n".join(bad[:20])
    return worst


def _set_environ(kv):
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@contextlib.contextmanager
def _environ(extra):
    """`extra` set in os.environ inside the block (None: unset), for the
    steps this process runs through `cli.main`; the old values back
    after, and the fault counters reset on the way in and out."""
    from shifu_tpu_torch import resilience
    old = {k: os.environ.get(k) for k in extra}
    _set_environ(extra)
    resilience.reset_faults()
    try:
        yield
    finally:
        _set_environ(old)
        resilience.reset_faults()


def p15_twins(card, cpu, verb, device="cuda", env=None):
    """`verb` on the card and, beside it, with `--device cpu` on the CPU
    twin, both under phase 15's chunk knobs (`env`); returns (card line,
    CPU line)."""
    env = dict(P15_ENV, **(env or {}))
    proc = _start_step(cpu, verb, "cpu", dict(CPU_TWIN_ENV, **env))
    card_line, (cpu_line,) = beside([(proc, f"{verb} --device cpu on {cpu}")],
                                    lambda: run_step(card, verb, device, env))
    return card_line, cpu_line


def p15_nn_params(rng, dims):
    """Xavier-uniform weights, small random biases, for `dims`."""
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        out.append({"w": rng.uniform(-lim, lim, (fan_in, fan_out))
                    .astype(np.float32),
                    "b": rng.normal(0, 0.01, fan_out).astype(np.float32)})
    return out


def p15_nn_set(root, card):
    """An NN set over the table of `card` with ZSCALE and no categorical
    column (c0 and c1 as meta: the fused first layer, K1), its
    ColumnConfig.json the card's streaming stats with c0 and c1 flagged
    meta, and a 28 → 64 → 1 NN from a seed."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.fileio import atomic_write
    from shifu_tpu_torch.models.spec import save_model
    with open(os.path.join(card, "ModelConfig.json")) as f:
        d = json.load(f)
    cols_dir = os.path.join(root, "columns")
    os.makedirs(cols_dir)
    with atomic_write(os.path.join(cols_dir, "meta.column.names")) as f:
        f.write("id\nmonth\nday\nc0\nc1\n")
    d["basic"] = {"name": "smokeP15NN"}
    d["dataSet"].update(categoricalColumnNameFile="",
                        metaColumnNameFile=os.path.join(
                            cols_dir, "meta.column.names"))
    d["normalize"] = {"normType": "ZSCALE", "stdDevCutOff": CUTOFF}
    d["train"] = {"algorithm": "NN"}
    ModelConfig.from_dict(d).save(root)
    ccs = column_configs(card)
    for c in ccs:
        if c["columnName"] in ("c0", "c1"):
            c["columnFlag"] = "Meta"
    with atomic_write(os.path.join(root, "ColumnConfig.json")) as f:
        json.dump(ccs, f, indent=1)
    save_model(os.path.join(root, "models", "model0.nn"), "nn",
               {"spec": {"input_dim": GBT_COLS, "hidden_dims": [64],
                         "activations": ["relu"]}},
               p15_nn_params(np.random.default_rng(153), [GBT_COLS, 64, 1]))


def p15_mc_set(root, device="cuda", rows=P15_MC_ROWS):
    """A 3-class set (phase 12's table at `rows` rows, scored as its own
    eval set): `init` and the streaming `stats` on the card, a resident
    `norm`, and a NATIVE NN (28 → 64 → 3) trained on the card for three
    epochs."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, *mc_raw_table(np.random.default_rng(152), rows))
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["c0"],
                "negTags": ["c1", "c2"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeP15MC"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": dict(nn_train_fields("NN", "M", 0.1, hidden=(64,), bags=1,
                                      epochs=3, Momentum=0.5),
                      multiClassifyMethod="NATIVE"),
        "evals": [{"name": "Eval1", "dataSet": data_set}]}).save(root)
    resident = {"SHIFU_TPU_NORM_CHUNK_ROWS": "0"}
    return {"init": run_step(root, "init", env_extra=P15_ENV),
            "stats": run_step(root, "stats", device, P15_ENV),
            "norm": run_step(root, "norm", device, dict(P15_ENV, **resident)),
            "train": run_step(root, "train", device, P15_ENV)}


def phase_past_trigger(report, workdir, device="cuda", rows=P15_ROWS,
                       mc_rows=P15_MC_ROWS):
    """Phase 15: every ported verb past its size trigger (the chunk knobs
    of `P15_ENV`), each a `python -m shifu_tpu_torch` process on the card
    beside its `--device cpu` twin."""
    import shutil
    t0 = time.perf_counter()
    card = os.path.join(workdir, "p15")
    raw_bytes = write_model_set(card, "GBT", P15_TREES["GBT"], 150, rows,
                                0.1, extras=True, cohorts=True)
    set_config(card, "train", trainOnDisk=True)
    set_config(card, "normalize", normType="WOE")
    set_config(card, "varSelect", filterNum=15)
    add_eval_set(card, "p15", os.path.join(card, "data"))
    lines = {"init": (run_step(card, "init", env_extra=P15_ENV), None)}
    cpu = os.path.join(workdir, "p15_cpu")
    shutil.copytree(card, cpu, ignore=shutil.ignore_patterns("data"))
    errs, failed = {}, []

    def gate(name, fn):
        """One gate; a failed one is printed and the phase goes on, so the
        run reports every gate (the phase fails at its end)."""
        try:
            errs[name] = fn()
        except AssertionError as e:
            print(f"  GATE FAILED {name}: {e}")
            failed.append(f"{name}: {e}")

    def step(verb):
        name = verb if isinstance(verb, str) else " ".join(verb)
        lines[name] = p15_twins(card, cpu, verb, device)
        assert lines[name][0]["rows"] == rows, (name, lines[name][0])
        return name

    mc = os.path.join(workdir, "p15_mc")

    def flags():
        """`stats`, then its three readers side by side."""
        step("stats")
        gate("stats", lambda: compare_streaming_configs(card, cpu))
        in_parallel(lambda: step(["stats", "-correlation"]),
                    lambda: step(["stats", "-psi"]), lambda: step("norm"))
    mc_steps = in_parallel(lambda: p15_mc_set(mc, device, mc_rows),
                           flags)[0]
    gate("correlation", lambda: compare_corr(
        _pf_path(card, "correlation_path"),
        _pf_path(cpu, "correlation_path")))

    def psi_gate():
        a, b = column_configs(card), column_configs(cpu)
        psi = max(abs(x["columnStats"]["psi"] - y["columnStats"]["psi"])
                  for x, y in zip(a, b)
                  if y["columnStats"].get("psi") is not None)
        assert psi <= 1e-6, f"psi card vs CPU {psi}"
        with open(_pf_path(card, "psi_path")) as f, \
                open(_pf_path(cpu, "psi_path")) as g:
            assert f.read().split("\n")[0] == g.read().split("\n")[0]
        return psi
    gate("psi", psi_gate)
    gate("norm layout", lambda: compare_layout(card, cpu))

    # varsel on copies (KS on the host; FI trains an RF through the
    # streaming norm and builder, K3 and K5 counted between markers)
    # beside the streaming GBT and RF trainings on the card
    vs = {}
    for by in ("KS", "FI"):
        pair = [copy_config(r, os.path.join(workdir, f"p15_vs_{by}_{w}"))
                for r, w in ((card, "card"), (cpu, "cpu"))]
        for r in pair:
            set_config(r, "varSelect", filterBy=by)
            if by == "FI":
                set_config(r, "train", algorithm="RF", validSetRate=0.0,
                           params=P15_TREES["RF"])
        vs[by] = pair
    steps = [(vs[by][0], ["varsel"]) for by in ("KS", "FI")]
    path = os.path.join(workdir, "p15_cpu_verbs.json")
    with open(path, "w") as f:
        json.dump([(vs[by][1], ["varsel"]) for by in ("KS", "FI")], f)
    fi = {}

    def card_varsel():
        from shifu_tpu_torch.ops import best_splits, level_hist
        with _environ(P15_ENV):
            ks = run_verbs(steps[:1], device)[0]
            before = (level_hist.launches + level_hist.fused_launches,
                      best_splits.launches)
            names = kernels_between_markers(
                lambda: fi.setdefault("line", run_verbs(steps[1:],
                                                        device)[0]))
        fi.update(k3k4=count_kernels(names, "level_hist"),
                  k5=count_kernels(names, "best_splits"),
                  counters=(level_hist.launches + level_hist.fused_launches
                            - before[0], best_splits.launches - before[1]))
        return ks

    def varsel():
        twin = _spawn([os.path.abspath(__file__), "--cpu-verbs", path],
                      dict(CPU_TWIN_ENV, **P15_ENV))
        return beside([(twin, f"--cpu-verbs {path}")], card_varsel)

    rf = copy_tmp(card, os.path.join(workdir, "p15_rf"))
    set_config(rf, "train", algorithm="RF", validSetRate=0.0,
               params=P15_TREES["RF"])
    (ks, (cpu_vs,)), gbt_line, rf_line = in_parallel(
        varsel, lambda: run_step(card, "train", device, P15_ENV),
        lambda: run_step(rf, "train", device, P15_ENV))
    trains = {"GBT": gbt_line, "RF": rf_line}
    print(f"  varsel KS card rc {ks['rc']}, FI card "
          f"{fi['line']['seconds']:.2f} s: K3/K4 {fi['k3k4']}, K5 "
          f"{fi['k5']} between markers (counters {fi['counters']})")
    assert ks["rc"] == 0 and fi["line"]["rc"] == 0 and \
        all(c["rc"] == 0 for c in cpu_vs)

    def vs_gate():
        for by in ("KS", "FI"):
            assert selection(vs[by][0]) == selection(vs[by][1]), \
                f"varsel {by}: card and CPU select other columns"
        assert fi["k3k4"] > 0 and fi["k5"] > 0 and \
            fi["k3k4"] == fi["counters"][0] and \
            fi["k5"] == fi["counters"][1], fi
        return {"selected": len(selection(vs["FI"][0]))}
    gate("varsel", vs_gate)
    report["level_hist"]["launches"] += fi["counters"][0]
    report["best_splits"]["launches"] += fi["counters"][1]
    for name, line in trains.items():
        print(f"  train {name} (trainOnDisk) on the card: {json.dumps(line)}")
        for k in ("level_hist", "best_splits"):
            assert line["launches"][k] > 0, (name, line)
            report[k]["launches"] += line["launches"][k]

    # the streaming eval of the GBT + RF set (K2), of an NN over ZSCALE
    # (K1) and of a 3-class NN, side by side
    shutil.copy(os.path.join(rf, "models", "model0.rf"),
                os.path.join(card, "models", "model1.rf"))
    ens_cpu = copy_models(card, os.path.join(workdir, "p15_ens_cpu"))
    nn = os.path.join(workdir, "p15_nn")
    p15_nn_set(nn, card)
    nn_cpu = copy_models(nn, os.path.join(workdir, "p15_nn_cpu"))
    mc_cpu = copy_models(mc, os.path.join(workdir, "p15_mc_cpu"))
    lines["eval trees"], lines["eval nn"], lines["eval multi-class"] = \
        in_parallel(
            lambda: p15_twins(card, ens_cpu, "eval", device),
            lambda: p15_twins(nn, nn_cpu, "eval", device),
            lambda: p15_twins(mc, mc_cpu, "eval", device, {
                "SHIFU_TPU_EVAL_CHUNK_ROWS": str(mc_rows // 4)}))
    gate("eval trees", lambda: compare_eval_dir(card, ens_cpu, "p15", 1e-6))
    def nn_gate():
        # scores within phase 11's 1e-5 (K1's 3xTF32); the AUCs within
        # 1e-6 plus the share of pairs that K1's error can reorder
        # (C-port-5: a near-random model packs many pairs that close)
        out = compare_eval_dir(nn, nn_cpu, "p15", 1e-5, auc_tol=1e-6,
                               reorder=True)
        print(f"  eval nn AUC gate: auc_err {out['auc_err']:.3e} <= "
              f"1e-6 + allowance {out['auc_allowance']:.3e}")
        return out
    gate("eval nn", nn_gate)
    gate("eval multi-class", lambda: compare_multiclass_eval(
        mc, mc_cpu, "Eval1", 1e-5, rows=1))
    for name, kernel in (("eval trees", "fused_trees"),
                         ("eval nn", "fused_score")):
        card_line = lines[name][0]
        assert card_line["launches"][kernel] > 0, (name, card_line)
        report[kernel]["launches"] += card_line["launches"][kernel]
    for d in (card, nn):
        with open(os.path.join(d, "evals", "p15",
                               "EvalPerformance.json")) as f:
            assert json.load(f)["streaming"]["chunks"] == \
                -(-rows // P15_CHUNK), d
    for name, (a, b) in lines.items():
        print(f"  {name}: card {json.dumps(a)}"
              + (f"; CPU twin {b['seconds']:.2f} s" if b else ""))
    print("  past the trigger, card = CPU: " + json.dumps(errs))
    assert not failed, "phase 15 gates failed:\n" + "\n".join(failed)
    report["phase15"] = {"rows": rows, "chunk_rows": P15_CHUNK,
                         "raw_bytes": raw_bytes, "errors": errs,
                         "steps": lines, "mc": mc_steps,
                         "trains": trains, "fi": fi,
                         "seconds": time.perf_counter() - t0}


def trigger_walls(rows=HIGGS_ROWS, chunk=STREAM_WALL_CHUNK):
    """`stats`, `norm` and `eval` (a 10-tree GBT) on the card at `rows`
    rows of phase 10's table, resident and then streaming (ChunkRows
    `chunk`), each a process: each step's read, compute and write
    seconds (the write is the streaming steps' own; the resident ones
    count it in compute)."""
    import shutil
    out = {"rows": rows, "chunk_rows": chunk}
    env = {f"SHIFU_TPU_{k}_CHUNK_ROWS": str(chunk)
           for k in ("STATS", "NORM", "EVAL")}
    zero = {k: "0" for k in env}
    with tempfile.TemporaryDirectory() as workdir:
        res = os.path.join(workdir, "resident")
        t0 = time.perf_counter()
        out["raw_bytes"] = write_model_set(
            res, "GBT", {"TreeNum": HIGGS_TREES, "MaxDepth": TRAIN_DEPTH,
                         "LearningRate": TRAIN_LR, "Loss": "log"}, 77, rows,
            0.1, extras=True)
        out["write_table_s"] = time.perf_counter() - t0
        add_eval_set(res, "walls", os.path.join(res, "data"))
        run_step(res, "init", env_extra=zero)
        stream = os.path.join(workdir, "stream")
        shutil.copytree(res, stream, ignore=shutil.ignore_patterns("data"))
        set_config(stream, "train", trainOnDisk=True)
        steps = {"resident": {}, "streaming": {}}
        for verb in ("stats", "norm"):
            steps["resident"][verb] = run_step(res, verb, "cuda", zero)
            steps["streaming"][verb] = run_step(stream, verb, "cuda", env)
        run_step(res, "train", "cuda", zero)
        shutil.copytree(os.path.join(res, "models"),
                        os.path.join(stream, "models"))
        steps["resident"]["eval"] = run_step(res, "eval", "cuda", zero)
        steps["streaming"]["eval"] = run_step(stream, "eval", "cuda", env)
    for how, by_step in steps.items():
        out[how] = {}
        for verb, line in by_step.items():
            read = line.get("read_seconds", 0.0)
            write = line.get("write_s", line.get("write_seconds", 0.0))
            out[how][verb] = {"rows": line["rows"], "read_s": read,
                              "write_s": write,
                              "compute_s": line["seconds"] - read - write,
                              "seconds": line["seconds"]}
    return out


# ---------------------------------------------------------------------------
# Phase 16: serving graphs, hot swap, registry/fleet, the health plane
# ---------------------------------------------------------------------------

P16_MIXED = 512             # mixed-size requests of the steady-state gate
P16_SWAPS = 10
P16_NN_ROWS = 8_192         # the two swap NNs' training rows
P16_HEALTH_ROWS = 20_000    # the health set's raw table (HIGGS widths)
P16_GBT = {"TreeNum": 5, "MaxDepth": 4, "LearningRate": 0.2,
           "Loss": "log"}


def same_scores(a, b):
    """Two `Scorer.score` dicts equal to the bit (NaN equal to NaN)."""
    return set(a) == set(b) and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in b)


@contextlib.contextmanager
def p16_traced(root):
    """A trace run of its own (SHIFU_TPU_TRACE=1, a ring that holds
    every span of the block) around the block; yields the run."""
    from shifu_tpu_torch.obs import trace as obs_trace
    with _environ({"SHIFU_TPU_TRACE": "1", "SHIFU_TPU_TRACE_BUF": "65536",
                   "SHIFU_TPU_TRACE_DIR": None}):
        with obs_trace.trace_run(root, "serve") as run:
            assert run is not None
            yield run


# the largest |span − timing split| (d) allows: one microsecond
P16_SPAN_TOL_S = 1e-6


def p16_span_gate(run, reqs):
    """(d) Every request of the traced traffic has one `serve.request`
    span (its submit time the span's start) whose five children equal
    its `timing` splits within P16_SPAN_TOL_S."""
    from shifu_tpu_torch.obs import trace as obs_trace
    spans = run.tracer.spans()
    assert run.tracer.summary()["dropped_spans"] == 0
    by_ts = {s["ts"]: s for s in spans if s["name"] == "serve.request"}
    kids = {}
    for s in spans:
        if s["parent"] is not None and s["name"].startswith("serve."):
            kids.setdefault(s["parent"], {})[s["name"]] = s["dur"]
    worst = 0.0
    for r in reqs:
        req = by_ts[obs_trace.wall(r.t_submit)]
        got = kids[req["id"]]
        assert set(got) == {f"serve.{k}" for k in
                            ("queue", "pad", "h2d", "device", "d2h")}, got
        for k in ("queue", "pad", "h2d", "device", "d2h"):
            worst = max(worst, abs(got[f"serve.{k}"] - r.timing[f"{k}_s"]))
        worst = max(worst, abs(req["dur"] - r.timing["total_s"]))
    assert worst <= P16_SPAN_TOL_S, worst
    return {"requests": len(by_ts), "spans": len(spans),
            "max_abs_s": worst}


def p16_graphs(report, workdir, device="cuda"):
    """(a) Phase 4's two services with graphs, beside an eager twin on
    the card and a CPU twin: one capture per (model, bucket); every
    bucket and phase 4's sizes bit-equal to the eager path and within
    phase 4's tolerances of the CPU; P16_MIXED mixed-size requests (four
    in flight) capture nothing; the K1/K2 launches of that traffic are
    counted through the replays, and one replay of each service's top
    bucket launches, between marker kernels, what its capture counted.
    Returns the launches of the mixed traffic."""
    from shifu_tpu_torch.ops import fused_score, fused_trees
    from shifu_tpu_torch.serve.service import ScorerService
    rng = np.random.default_rng(161)
    nn_dir, tree_dir, norm, nn_rows, tree_req = serving_sets(workdir, rng)
    launched = {"fused_score": 0, "fused_trees": 0}
    out = {}
    for name, kw, make, tol in (
            ("nn+norm", {"models_dir": nn_dir, "norm": norm}, nn_rows,
             dict(rtol=1e-5, atol=1e-5)),
            ("gbt+rf", {"models_dir": tree_dir}, tree_req,
             dict(rtol=1e-6, atol=1e-6))):
        proto = make(rng, 1)
        svcs = [ScorerService(max_delay=0.0005, device=d, graphs=g, **kw)
                for d, g in ((device, True), (device, False),
                             ("cpu", False))]
        try:
            t0 = time.monotonic()
            svcs[0].start(proto=proto)
            warm_s = time.monotonic() - t0
            for s in svcs[1:]:
                s.start(proto=proto)
            graph, eager, cpu = svcs
            st = graph.stats()
            n_graphs = len(st["models"]) * len(graph.ladder) \
                if device == "cuda" else 0
            assert st["graphs"] == st["graph_captures"] == n_graphs, st
            for n in sorted(set(graph.ladder) | set(SIZES)):
                blocks = make(rng, n)
                got = graph.submit(**blocks, timeout=120)
                assert same_scores(got, eager.submit(**blocks,
                                                     timeout=120)), \
                    f"{name} n={n}: graph scores differ from eager"
                want = cpu.submit(**blocks, timeout=120)
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], **tol,
                                               err_msg=f"{name} n={n} {k}")
            sizes = np.random.default_rng(7).integers(
                1, graph.ladder[-1] + 1, P16_MIXED)
            payloads = [make(rng, int(n)) for n in sizes]
            fused_score.launches = 0
            fused_trees.launches = 0
            reqs = []
            with p16_traced(os.path.join(workdir, "p16_trace_" + name)) \
                    as run:
                t0 = time.monotonic()
                for i in range(0, P16_MIXED, 4):
                    pend = [graph.submit_async(**b)
                            for b in payloads[i:i + 4]]
                    for r in pend:
                        r.wait(120)
                    reqs += pend
                mixed_s = time.monotonic() - t0
            spans_gate = p16_span_gate(run, reqs)
            counts = {"fused_score": fused_score.launches,
                      "fused_trees": fused_trees.launches}
            after = graph.stats()
            assert after["graph_captures"] == st["graph_captures"], after
            kernel = "fused_score" if name == "nn+norm" else "fused_trees"
            assert counts[kernel] > 0, f"{name}: {kernel} not launched"
            for k, v in counts.items():
                launched[k] += v
            seen = None
            if device == "cuda":
                # one replay under the profiler (its launches not counted)
                g = graph._graphs.graphs[(0, graph.ladder[-1])]
                saved = (fused_score.launches, fused_trees.launches)
                names = kernels_between_markers(g.replay)
                fused_score.launches, fused_trees.launches = saved
                seen = {k: sum(1 for n in names if pat in n)
                        for k, pat in (("fused_score", "fused_score_kernel"),
                                       ("fused_trees", "fused_trees_"))}
                want_k = {k: g.kernels.get(k, 0) for k in seen}
                assert seen == want_k, (name, seen, want_k, names)
            out[name] = {"graphs": st["graphs"], "warm_s": warm_s,
                         "captures_after_mixed": after["graph_captures"],
                         "mixed_requests": P16_MIXED, "mixed_s": mixed_s,
                         "traced": spans_gate,
                         "batches": after["batcher"]["batches"],
                         "launches": counts, "replay_kernels": seen}
            print(f"  (a) {name}: {json.dumps(out[name])}")
        finally:
            for s in svcs:
                s.close()
    report["p16_graphs"] = out
    return launched


def p16_swap_sets(workdir, device="cuda"):
    """Two NNs of phase 4's shape trained by the port (`train_nn`, 2
    epochs, ADAM) on the same rows from two seeds, saved as model sets;
    and a third set of another shape."""
    import dataclasses

    from shifu_tpu_torch.config.model_config import ModelTrainConf
    from shifu_tpu_torch.models.spec import save_model
    from shifu_tpu_torch.train import trainer
    rng = np.random.default_rng(162)
    x = rng.normal(0, 1, (P16_NN_ROWS, NN_IN)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + rng.logistic(0, 1, P16_NN_ROWS) > 0) \
        .astype(np.float32)
    conf = ModelTrainConf()
    conf.params = {"NumHiddenLayers": 2, "NumHiddenNodes": list(NN_HIDDEN),
                   "ActivationFunc": ["relu", "relu"],
                   "Propagation": "ADAM", "LearningRate": 0.002}
    conf.numTrainEpochs, conf.baggingNum = 2, 1
    dirs = []
    for seed in (1, 2):
        res = trainer.train_nn(conf, x, y, np.ones_like(y), seed=seed,
                               device=device)
        d = os.path.join(workdir, f"swap{seed}")
        save_model(os.path.join(d, "model0.nn"), "nn",
                   {"spec": json.loads(json.dumps(
                       dataclasses.asdict(res.spec)))},
                   res.params_per_bag[0])
        dirs.append(d)
    bad = os.path.join(workdir, "swap_other_shape")
    save_model(os.path.join(bad, "model0.nn"), "nn",
               {"spec": {"input_dim": NN_IN, "hidden_dims": [64],
                         "activations": ["relu"]}},
               [{"w": np.zeros((NN_IN, 64), np.float32),
                 "b": np.zeros(64, np.float32)},
                {"w": np.zeros((64, 1), np.float32),
                 "b": np.zeros(1, np.float32)}])
    return dirs, bad


def p16_swap(report, workdir, dirs, bad, device="cuda"):
    """(b) A graph service (NN with norm, K1) over the first set; one
    thread submits without pause while `swap_params` flips between the
    two sets P16_SWAPS times: every answer equals one set's eager scores
    as a whole, none fails, no graph is captured again; the other-shaped
    set returns False and leaves the scores as they were."""
    import threading

    from shifu_tpu_torch.serve.service import ScorerService
    rng = np.random.default_rng(163)
    mean, std = norm_params(rng)
    norm = {"mean": mean, "std": std, "cutoff": CUTOFF}
    reqs = [{"raw_dense": raw_rows(rng, n, mean, std)}
            for n in (1, 3, 8, 40, 64, 300, 512)]
    want = []
    for d in dirs:
        ref = ScorerService(models_dir=d, norm=norm, device=device,
                            graphs=False).start(proto=reqs[0])
        try:
            want.append([ref.submit(**r, timeout=120)["mean"] for r in reqs])
        finally:
            ref.close()
    assert not np.array_equal(want[0][-1], want[1][-1])
    svc = ScorerService(models_dir=dirs[0], norm=norm, max_delay=0.0002,
                        device=device).start(proto=reqs[0])
    captures = svc.graph_captures
    seen, errors, stop = [0, 0], [], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            j = i % len(reqs)
            i += 1
            try:
                got = svc.submit(**reqs[j], timeout=120)["mean"]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            hit = [np.array_equal(got, w[j]) for w in want]
            if not any(hit):
                errors.append(f"request {j}: neither old nor new scores")
                return
            seen[hit.index(True)] += 1
    t = threading.Thread(target=client)
    try:
        t.start()
        swap_s = []
        for k in range(P16_SWAPS):
            time.sleep(0.05)
            t0 = time.monotonic()
            assert svc.swap_params(dirs[(k + 1) % 2]), f"swap {k} refused"
            swap_s.append(time.monotonic() - t0)
        time.sleep(0.05)
        refused = svc.swap_params(bad)
        stop.set()
        t.join()
        assert not errors, errors
        assert not refused, "an other-shaped set was swapped in"
        assert seen[0] > 0 and seen[1] > 0, seen
        assert svc.swaps == P16_SWAPS and svc.graph_captures == captures
        for j, r in enumerate(reqs):
            assert np.array_equal(svc.submit(**r, timeout=120)["mean"],
                                  want[P16_SWAPS % 2][j])
    finally:
        stop.set()
        t.join()
        svc.close()
    out = {"swaps": P16_SWAPS, "answers_old_new": seen,
           "captures": captures, "swap_ms": [v * 1e3 for v in swap_s]}
    print(f"  (b) swap under load: {json.dumps(out)}")
    report["p16_swap"] = out


def p16_fleet(report, workdir, dirs, device="cuda"):
    """(c) A registry: `nn` (two versions: the swap sets), `trees` (phase
    4's GBT + RF) and `nn_low` (priority low, phase 4's NN); a fleet on
    the card under an SHIFU_TPU_FLEET_HBM_MB that holds two of them:
    routes bit-equal to standalone services, evictions and re-warms
    counted, memory freed by an eviction, low priority shed under a
    tiny SLO while high flows, and `rollback` + `swap_in_place` and
    `gc` on the registry."""
    from shifu_tpu_torch import registry
    from shifu_tpu_torch.serve.fleet import FleetService, ShedReject
    from shifu_tpu_torch.serve.service import ScorerService
    import torch
    rng = np.random.default_rng(164)
    src = os.path.join(workdir, "fleet_src")
    p4_nn, p4_trees, _, _, _ = serving_sets(src, np.random.default_rng(42))
    reg = os.path.join(workdir, "registry")
    assert registry.publish(reg, "nn", dirs[0]) == "v001"
    assert registry.publish(reg, "nn", dirs[1]) == "v002"
    registry.publish(reg, "trees", p4_trees)
    registry.publish(reg, "nn_low", p4_nn, priority="low")
    sizes = {}
    for name in ("nn", "trees", "nn_low"):
        m = registry.read_manifest(reg, name)
        sizes[name] = m["param_bytes"] + m["ladder"][-1] * \
            m["working_row_bytes"]
    # whole MiB (the knob is an int): an NN and the trees fit, two NNs
    # do not
    budget = math.ceil((sizes["nn"] + sizes["trees"]) / float(1 << 20))
    assert budget * (1 << 20) < sizes["nn"] + sizes["nn_low"], sizes
    dense = {n: rng.normal(0, 1, (n, NN_IN)).astype(np.float32)
             for n in (1, 7, 64, 512)}
    trees = {n: {"raw_dense": tree_rows(rng, n)} for n in (1, 7, 64, 512)}

    def request(name, n):
        return trees[n] if name == "trees" else {"dense": dense[n]}

    old = os.environ.get("SHIFU_TPU_FLEET_HBM_MB")
    os.environ["SHIFU_TPU_FLEET_HBM_MB"] = str(budget)
    # no shedding until the shed check below sets a tiny SLO
    fleet = FleetService(reg, workspace_root=workdir, device=device,
                         slo_p99_ms=1e9)
    out = {"budget_mb": budget, "sizes_bytes": sizes}
    try:
        assert fleet._budget_bytes == budget * (1 << 20)
        got = {}
        for name in ("nn", "trees", "nn_low"):
            for n in (1, 7, 64, 512):
                got[(name, n)] = fleet.submit(name, timeout=120,
                                              **request(name, n))
        st = fleet.stats()
        # nn_low's warm evicted nn: the trees and nn_low stay
        assert fleet.resident() == ["trees", "nn_low"], fleet.resident()
        assert st["fleet"]["evictions"] == 1, st["fleet"]
        for name in ("nn", "trees", "nn_low"):
            _, vdir, manifest = registry.resolve(reg, name)
            solo = ScorerService(models_dir=vdir, device=device,
                                 ladder=tuple(manifest["ladder"])).start()
            try:
                for n in (1, 7, 64, 512):
                    assert same_scores(got[(name, n)], solo.submit(
                        timeout=120, **request(name, n))), (name, n)
            finally:
                solo.close()
        # a route that re-warms (nn was evicted by nn_low's warm; its
        # warm evicts the two others)
        again = fleet.submit("nn", timeout=120, **request("nn", 64))
        assert same_scores(again, got[("nn", 64)])
        assert fleet.resident() == ["nn"], fleet.resident()
        st = fleet.stats()
        assert st["fleet"]["evictions"] == 3 and \
            st["fleet"]["rewarm_s"] > 0, st["fleet"]
        out.update(evictions=st["fleet"]["evictions"],
                   rewarm_s=st["fleet"]["rewarm_s"],
                   resident=fleet.resident())
        # memory an eviction frees: the resident model's weights, packs,
        # static buffers and graph pool (reserved after empty_cache)
        victim = fleet.resident()[0]

        def mem():
            if device != "cuda":
                return 0, 0
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        before = mem()
        with fleet._lock:
            fleet._evict_locked(fleet._entries[victim])
        after = mem()
        assert after[0] < before[0] or device != "cuda", (before, after)
        out["evict_freed"] = {"model": victim,
                              "allocated_before_after": [before[0], after[0]],
                              "reserved_before_after": [before[1], after[1]]}
        # shed: low priority rejected under a tiny SLO, high flows
        fleet.set_slo(1e-3)
        for _ in range(8):
            fleet.submit("nn", timeout=120, **request("nn", 7))
        shed = 0
        for _ in range(8):
            try:
                fleet.submit("nn_low", timeout=120, **request("nn_low", 7))
            except ShedReject:
                shed += 1
        assert shed == 8, shed
        assert fleet.submit("nn", timeout=120,
                            **request("nn", 7))["mean"].shape == (7,)
        fleet.set_slo(1e9)
        fleet.submit("nn", timeout=120, **request("nn", 1))
        assert fleet.submit("nn_low", timeout=120, **request(
            "nn_low", 7))["mean"].shape == (7,)
        out["shed_low"] = shed
        out["rejected_by_class"] = fleet.rejected_by_class()
        # rollback: HEAD back to v001, swapped into the live graphs
        assert registry.rollback(reg, "nn") == "v001"
        assert fleet.swap_in_place("nn") in ("swapped", "cold")
        v1 = ScorerService(models_dir=dirs[0], device=device).start()
        try:
            assert same_scores(fleet.submit("nn", timeout=120,
                                            **request("nn", 64)),
                               v1.submit(timeout=120, **request("nn", 64)))
        finally:
            v1.close()
        assert registry.gc(reg, "nn", keep=1) == []
        assert registry.rollback(reg, "nn", to="v002") == "v002"
        assert registry.gc(reg, "nn", keep=1) == ["v001"]
        out["fleet"] = fleet.stats()["fleet"]
    finally:
        fleet.close()
        if old is None:
            os.environ.pop("SHIFU_TPU_FLEET_HBM_MB", None)
        else:
            os.environ["SHIFU_TPU_FLEET_HBM_MB"] = old
    print(f"  (c) registry and fleet: {json.dumps(out)}")
    report["p16_fleet"] = out


def _drift_points(root):
    from shifu_tpu_torch.obs.health import store
    return [(p["name"], p["value"], p["tags"])
            for p in store.MetricsStore(root).read_points()
            if p["name"].startswith("drift.")]


def p16_health(report, workdir, device="cuda", rows=P16_HEALTH_ROWS):
    """(d) With SHIFU_TPU_METRICS=1: a GBT set at the HIGGS widths made
    by the port's `init → stats → norm → train` and `eval` on the card
    (eval writes `eval.*` points), a served trees service's flusher
    (`serve.*` points); then the data shifts (+1.5 in every column) and
    `watch --monitor-only --iterations 3` on the card breaches
    `drift.psi_max`; on a copy, the same watch with `--device cpu` gives
    the same drift points to the bit; `health` exits 1 and `/healthz`
    reports the breach."""
    import contextlib
    import io
    import shutil

    from shifu_tpu_torch import cli
    from shifu_tpu_torch.obs.health import store
    from shifu_tpu_torch.serve.http import HttpFrontEnd
    from shifu_tpu_torch.serve.service import ScorerService
    root = os.path.join(workdir, "health")
    old = {k: os.environ.get(k) for k in ("SHIFU_TPU_METRICS",
                                          "SHIFU_TPU_METRICS_FLUSH_S")}
    os.environ.update(SHIFU_TPU_METRICS="1", SHIFU_TPU_METRICS_FLUSH_S="0.2")
    try:
        write_model_set(root, "GBT", P16_GBT, 165, rows, 0.1)
        holdout = os.path.join(workdir, "health_holdout")
        names, cols, _, _ = raw_table(np.random.default_rng(166), 4096,
                                      False)
        write_raw(holdout, names, cols)
        add_eval_set(root, "holdout", holdout)
        lines = run_verbs([(root, [v]) for v in ("init", "stats", "norm",
                                                  "train", "eval")], device)
        assert all(ln["rc"] == 0 for ln in lines), lines
        points = store.MetricsStore(root).read_points()
        evals = {p["name"]: p["value"] for p in points
                 if p["name"].startswith("eval.")}
        assert {"eval.auc", "eval.weighted_auc"} <= set(evals), evals
        svc = ScorerService(models_dir=os.path.join(root, "models"),
                            device=device, workspace_root=root).start(
            proto={"raw_dense": tree_rows(np.random.default_rng(1), 1)})
        front = HttpFrontEnd(svc, host="127.0.0.1", port=0).start()
        try:
            for n in (1, 8, 64, 300):
                svc.submit(raw_dense=tree_rows(np.random.default_rng(n), n),
                           timeout=120)
            time.sleep(0.5)
            serve_pts = {p["name"] for p in
                         store.MetricsStore(root).read_points()
                         if p["name"].startswith("serve.")}
            assert {"serve.p99_ms", "serve.requests",
                    "serve.reject_rate"} <= serve_pts, serve_pts
            # the shift, after stats froze the bins
            data = os.path.join(root, "data", "part-00000")
            tok = np.loadtxt(data, dtype=str, delimiter="|")
            num = tok[:, :GBT_COLS]
            ok = num != "?"
            num[ok] = (num[ok].astype(np.float32)
                       + np.float32(1.5)).astype(str)
            with open(data, "w") as f:
                f.write("\n".join("|".join(r) for r in tok.tolist()) + "\n")
            twin = os.path.join(workdir, "health_cpu")
            shutil.copytree(root, twin, ignore=shutil.ignore_patterns(
                "metrics.jsonl", "alerts.jsonl"))
            with contextlib.redirect_stdout(io.StringIO()):
                for r, dev in ((root, device), (twin, "cpu")):
                    assert cli.main(["--dir", r, "watch", "--monitor-only",
                                     "--iterations", "3", "--interval-s",
                                     "0", "--device", dev]) == 0
            card, cpu = _drift_points(root), _drift_points(twin)
            assert card and card == cpu, (card[:4], cpu[:4])
            psi = [v for n, v, _ in card if n == "drift.psi_max"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--dir", root, "health"])
            assert rc == 1 and "status: BREACH" in buf.getvalue(), \
                buf.getvalue()
            host, port = front.address
            with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=30) as resp:
                healthz = json.loads(resp.read())
            assert healthz["ok"] and healthz["status"] == "breach", healthz
            drift_rule = next(s for s in healthz["slo"]
                              if s["metric"] == "drift.psi_max")
            assert drift_rule["state"] == "breach", drift_rule
        finally:
            front.close()
            svc.close()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {"rows": rows, "eval": evals, "serve_points": sorted(serve_pts),
           "drift_points": len(card), "psi_max": psi,
           "health_rc": rc, "healthz_status": healthz["status"],
           "launches": {k: sum(ln.get("launches", {}).get(k, 0)
                               for ln in lines)
                        for k in ("fused_trees", "level_hist",
                                  "best_splits")}}
    print(f"  (d) health plane: {json.dumps(out)}")
    report["p16_health"] = out


def phase_serving_plane(report, workdir, device="cuda"):
    """Phase 16: (a) serving graphs, (b) a hot swap under load, (c) the
    registry and a fleet, (d) the health plane, on the card. Returns (b)'s
    two NN sets, which phase 17 reuses with (d)'s GBT set."""
    t0 = time.monotonic()
    launched = p16_graphs(report, workdir, device)
    dirs, bad = p16_swap_sets(workdir, device)
    p16_swap(report, workdir, dirs, bad, device)
    p16_fleet(report, workdir, dirs, device)
    p16_health(report, workdir, device)
    for k, v in launched.items():
        report[k]["launches"] += v
    for k, v in report["p16_health"]["launches"].items():
        report[k]["launches"] += v
    report["p16_seconds"] = time.monotonic() - t0
    print(f"  phase 16: {report['p16_seconds']:.1f} s")
    return dirs


P17_SEG_ROWS = 4_096        # SHIFU_TPU_INGEST_SEGMENT_ROWS of the row log
P17_BATCH = 1_024           # rows a producer appends at once
P17_NN_ROWS = 8_192         # the NN refresh's set and its window
P17_TOLERANCE = 0.2         # the guardrail tolerance of (b), (c) and (e)

def _set_copy(src, dst):
    """A copy of a model set without its metrics store (a fresh health
    history; its paths stay absolute, so it reads the same raw data)."""
    import shutil
    return shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "metrics", "alerts.jsonl"))


def _file_lines(path):
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def _tmp_residue(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.startswith(".tmp.")]


def p17_ingest(workdir, health):
    """(a) Phase 16 (d)'s shifted rows (the health set's data after the
    +1.5 shift) appended P17_BATCH at a time to a two-partition row log
    of P17_SEG_ROWS-row segments; a fault between the two renames of the
    first seal, then the rerun re-seals sequence 1 over the orphan and
    leaves no `.tmp.*`; `ingest ls` as a process reports the rows and
    every partition's segments."""
    import shutil

    from shifu_tpu_torch import resilience
    from shifu_tpu_torch.data.ingest import RowLog
    data = os.path.join(health, "data")
    header = _file_lines(os.path.join(data, ".pig_header"))[0].split("|")
    lines = _file_lines(os.path.join(data, "part-00000"))
    root = os.path.join(workdir, "p17_log")
    lg = RowLog(root, header=header, partitions=2)
    assert lg.segment_rows == P17_SEG_ROWS, lg.segment_rows
    os.environ["SHIFU_TPU_FAULT"] = "ingest.seal:oserror:2"
    resilience.reset_faults()
    try:
        for a in range(0, len(lines), P17_BATCH):
            try:
                lg.append(lines[a:a + P17_BATCH])
            except OSError as e:
                fault = (a, str(e))
                break
        else:
            raise AssertionError("the injected ingest.seal fault never fired")
    finally:
        os.environ.pop("SHIFU_TPU_FAULT", None)
        resilience.reset_faults()
    orphan = os.path.join(root, "part-0", "seg-000001.rows")
    assert os.path.exists(orphan) and RowLog(root).sealed_rows() == 0, \
        "the fault did not fall between the seal's two renames"
    resealed = lg.maybe_seal()
    assert (0, 1) in resealed, resealed
    for a in range(fault[0] + P17_BATCH, len(lines), P17_BATCH):
        lg.append(lines[a:a + P17_BATCH])
    lg.seal_all()
    assert lg.sealed_rows() == len(lines) and not _tmp_residue(root)
    pristine = shutil.copytree(root, os.path.join(workdir, "p17_log_pristine"))
    ls = _spawn(["-m", "shifu_tpu_torch", "ingest", "ls", "--log", pristine])
    out = {"rows": len(lines), "fault_at_row": fault[0], "fault": fault[1],
           "resealed": resealed}
    return root, pristine, out, ls


def p17_ingest_ls(ls, out):
    """(a)'s `ingest ls` process: the log's rows, each partition's rows
    and segments, no consumer yet."""
    stdout, err = ls.communicate(timeout=300)
    assert ls.returncode == 0, err[-2000:]
    inv = json.loads(stdout)
    n = out["rows"]
    rows = [n - n // 2, n // 2]
    segs = [p["sealed_segments"] for p in inv["partitions"]]
    assert inv["sealed_rows"] == n and inv["consumers"] == [] and \
        [p["sealed_rows"] for p in inv["partitions"]] == rows, inv
    assert segs == [-(-r // P17_SEG_ROWS) for r in rows], segs
    out["segments"] = segs
    print(f"  (a) row log: {json.dumps(out)}")


def card_beside_cpu(card_fn, cpu_fn):
    """`card_fn` on this thread (its profiler windows stay on the thread
    that owns the trace) while `cpu_fn` runs on a side thread; returns
    both results."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        side = pool.submit(cpu_fn)
        card = card_fn()
        return card, side.result()


def _client(fleet, model, reqs, stop, failures, answers):
    """Submit `reqs` round robin until `stop`; every answer's "mean" is
    kept by request index, every failure kept."""
    i = 0
    while not stop.is_set():
        j = i % len(reqs)
        i += 1
        try:
            answers.append((j, fleet.submit(model, timeout=120,
                                            **reqs[j])["mean"]))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            failures.append(repr(e))


def p17_gbt_refresh(workdir, health, log_root, pristine, swap_nn,
                    device="cuda"):
    """(b) Phase 16 (d)'s GBT set published and served from a fleet on
    the card under a client that never pauses; one `run_monitor` tick
    over the row log breaches on drift and its `RefreshController`
    retrains warm on the card (K3 and K5 counted between marker kernels),
    guards (K2), publishes and swaps by re-warm (the GBT grew trees).
    Meanwhile a fresh NN service (phase 16 (b)'s second set) captures its
    graphs mid-retrain and must score like its eager twin. The same
    controller with `device="cpu"` on a copy of the set and of the log
    reaches the same decision with AUCs within 1e-6."""
    import shutil
    import threading

    import torch

    from shifu_tpu_torch import registry
    from shifu_tpu_torch.data.ingest import RowLog
    from shifu_tpu_torch.obs.health import store, watch
    from shifu_tpu_torch.obs.health.refresh import RefreshController
    from shifu_tpu_torch.ops import best_splits, level_hist
    from shifu_tpu_torch.processor.base import ProcessorContext
    from shifu_tpu_torch.serve.fleet import FleetService
    from shifu_tpu_torch.serve.service import ScorerService
    ms = _set_copy(health, os.path.join(workdir, "p17_gbt"))
    twin = _set_copy(health, os.path.join(workdir, "p17_gbt_cpu"))
    cpu_log = shutil.copytree(pristine, os.path.join(workdir, "p17_log_cpu"))
    reg = os.path.join(workdir, "p17_reg")
    reg_cpu = os.path.join(workdir, "p17_reg_cpu")
    v1 = registry.publish(reg, "gbt", os.path.join(ms, "models"))
    registry.publish(reg_cpu, "gbt", os.path.join(twin, "models"))
    lg = RowLog(log_root)
    rng = np.random.default_rng(171)
    reqs = [{"raw_dense": tree_rows(rng, n)} for n in (1, 7, 64, 300)]
    fleet = FleetService(reg, workspace_root=ms, device=device,
                         slo_p99_ms=1e9)
    ctx = ProcessorContext.load(ms)
    ctl = RefreshController(ctx, registry_root=reg, model_name="gbt",
                            fleet=fleet, ingest_log=lg,
                            tolerance=P17_TOLERANCE, cooldown_s=0.0,
                            device=device)
    counted, mid = {}, {}
    train = ctl._train_challenger

    def capture_mid_retrain():
        proto = {"dense": np.random.default_rng(172).normal(
            0, 1, (64, NN_IN)).astype(np.float32)}
        try:
            with ScorerService(models_dir=swap_nn, device=device) as svc, \
                    ScorerService(models_dir=swap_nn, device=device,
                                  graphs=False) as eager:
                mid["captures"] = svc.graph_captures
                mid["equal"] = same_scores(svc.submit(**proto, timeout=120),
                                           eager.submit(**proto, timeout=120))
        except Exception as e:  # noqa: BLE001 — reported by the gate
            mid["error"] = repr(e)

    def train_counted(clone):
        # the challenger's models/ before training, so a profile taken
        # again (a lost marker) trains from the same warm start
        models = os.path.join(clone, "models")
        seed = shutil.copytree(models, models + ".seed")
        capturer = threading.Thread(target=capture_mid_retrain)

        def once():
            shutil.rmtree(models)
            shutil.copytree(seed, models)
            k3, k5 = level_hist.launches, best_splits.launches
            if not capturer.is_alive() and "captures" not in mid:
                capturer.start()
            train(clone)
            if device == "cuda":
                torch.cuda.synchronize()
            counted["k3"] = level_hist.launches - k3
            counted["k5"] = best_splits.launches - k5
        names = kernels_between_markers(once) if device == "cuda" else \
            (once() or [])
        capturer.join()
        shutil.rmtree(seed)
        counted["k3_between_markers"] = count_kernels(names, "level_hist")
        counted["k5_between_markers"] = count_kernels(names, "best_splits")
    ctl._train_challenger = train_counted

    def card():
        for r in reqs:       # resident and captured before the client
            fleet.submit("gbt", timeout=120, **r)
        stop, failures, answers = threading.Event(), [], []
        t = threading.Thread(target=_client, args=(fleet, "gbt", reqs, stop,
                                                   failures, answers))
        t.start()
        try:
            rc = watch.run_monitor(ctx, interval_s=0.0, iterations=1,
                                   refresh=ctl, ingest_log=lg, device=device)
            time.sleep(0.2)
        finally:
            stop.set()
            t.join()
        return rc, failures, len(answers)

    def cpu():
        c = RefreshController(ProcessorContext.load(twin),
                              registry_root=reg_cpu, model_name="gbt",
                              ingest_log=RowLog(cpu_log),
                              tolerance=P17_TOLERANCE, cooldown_s=0.0,
                              device="cpu")
        return c.handle_breach({"slo": "drift", "state": "breach"}), c
    t0 = time.monotonic()
    try:
        (rc, failures, served), (cpu_outcome, cpu_ctl) = card_beside_cpu(
            card, cpu)
        wall = time.monotonic() - t0
        assert rc == 0 and ctl.last_outcome == "promoted", ctl.stats()
        assert not failures and served > 0, failures[:3]
        assert registry.head(reg, "gbt") == "v002"
        assert fleet._entries["gbt"].version == "v002"
        swaps = [e["tags"].get("swap") for e in store.store(ms).events(
            limit=50, names=["refresh"]) if e["tags"].get("phase")
            == "promoted"]
        assert swaps == ["rewarmed"] and \
            fleet.stats()["fleet"]["swaps"] == 0, swaps
        got = {}
        for j, r in enumerate(reqs):
            got[j] = fleet.submit("gbt", timeout=120, **r)
        with ScorerService(models_dir=registry.resolve(reg, "gbt")[1],
                           device=device) as solo:
            for j, r in enumerate(reqs):
                assert same_scores(got[j], solo.submit(timeout=120, **r)), j
    finally:
        fleet.close()
    man = registry.resolve(reg, "gbt")[2]["refresh"]
    iw = man["ingest_window"]
    replay = "".join(ln + "\n" for ln in
                     RowLog(log_root).read_range(iw["start"], iw["end"]))
    with open(os.path.join(ms, "tmp", "refresh", "run0001", "window",
                           "part-00000"), "rb") as f:
        assert f.read() == replay.encode("utf-8"), \
            "the manifest's window is not the materialized one"
    assert iw["rows"] == lg.sealed_rows() and lg.lag("watch") == 0 and \
        lg.lag("refresh") == 0, (iw, lg.inventory())
    assert counted["k3"] > 0 and counted["k5"] > 0, counted
    if device == "cuda":
        assert counted["k3_between_markers"] == counted["k3"] and \
            counted["k5_between_markers"] == counted["k5"], counted
        assert "error" not in mid and mid["captures"] > 0 and mid["equal"], \
            mid
    cpu_man = registry.resolve(reg_cpu, "gbt")[2]["refresh"]
    assert cpu_outcome == ctl.last_outcome, cpu_ctl.stats()
    auc_err = max(abs(man[k] - cpu_man[k])
                  for k in ("incumbent_auc", "challenger_auc"))
    assert auc_err <= 1e-6, (man, cpu_man)
    assert not _tmp_residue(reg) and not _tmp_residue(log_root)
    out = {"served": served, "wall_s": wall, "head": "v002", "from": v1,
           "swap": swaps[0], "window_rows": iw["rows"],
           "incumbent_auc": man["incumbent_auc"],
           "challenger_auc": man["challenger_auc"],
           "cpu_auc_err": auc_err, "launches": counted,
           "capture_mid_retrain": mid}
    print(f"  (b) GBT refresh: {json.dumps(out)}")
    return out


def p17_gbt_start(workdir, swap_nn, device="cuda"):
    """Start (b) in a process of its own (`--p17-gbt`): a process that
    has traced the earlier phases loses marker records (the main run
    lost one in all six traces of (b)'s retrain), a fresh one keeps
    them; (c) runs meanwhile."""
    return _spawn([os.path.abspath(__file__), "--p17-gbt", workdir, swap_nn,
                   device])


def p17_gbt_finish(proc):
    """(b)'s result and its process's K1/K2/K3/K5 launches."""
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"--p17-gbt failed:\n{err[-4000:]}"
    lines = out.rstrip().splitlines()
    for line in lines[:-1]:
        print(line)
    return json.loads(lines[-1])


def p17_gbt_main(workdir, swap_nn, device):
    """The `--p17-gbt` process: (b) over the phase's work directory; its
    last line holds (b)'s result and this process's launches."""
    from shifu_tpu_torch.ops import best_splits, fused_score, fused_trees
    from shifu_tpu_torch.ops import level_hist
    os.environ.update(SHIFU_TPU_METRICS="1",
                      SHIFU_TPU_INGEST_SEGMENT_ROWS=str(P17_SEG_ROWS))
    out = p17_gbt_refresh(workdir, os.path.join(workdir, "health"),
                          os.path.join(workdir, "p17_log"),
                          os.path.join(workdir, "p17_log_pristine"),
                          swap_nn, device)
    out["process_launches"] = {
        "fused_score": fused_score.launches,
        "fused_trees": fused_trees.launches,
        "level_hist": level_hist.launches,
        "best_splits": best_splits.launches}
    print(json.dumps(out))


def p17_nn_set(root, incumbent, seed, device="cuda"):
    """The NN refresh's set: a P17_NN_ROWS-row raw table of 600 columns
    (its own eval set Eval1), `init` and `stats` on `device` in process,
    the training params of phase 16 (b)'s NNs (600 → 512 → 256 → 1,
    ADAM, two epochs) and `incumbent` (one of them) as models/."""
    import shutil

    from shifu_tpu_torch.config.model_config import ModelConfig
    names, tokens = nn_raw_table(np.random.default_rng(seed), P17_NN_ROWS)
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, names, tokens)
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["1"],
                "negTags": ["0"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeNNRefresh"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": {"algorithm": "NN", "numTrainEpochs": 2, "baggingNum": 1,
                  "validSetRate": 0.1, "params": {
                      "NumHiddenLayers": 2,
                      "NumHiddenNodes": list(NN_HIDDEN),
                      "ActivationFunc": ["relu", "relu"],
                      "Propagation": "ADAM", "LearningRate": 0.002}},
        "evals": [{"name": "Eval1", "dataSet": data_set}]}).save(root)
    lines = run_verbs([(root, ["init"]), (root, ["stats"])], device)
    assert all(ln["rc"] == 0 for ln in lines), lines
    os.makedirs(os.path.join(root, "models"))
    shutil.copy(os.path.join(incumbent, "model0.nn"),
                os.path.join(root, "models", "model0.nn"))
    return root


def p17_nn_refresh(workdir, swap_dirs, device="cuda"):
    """(c) Phase 16 (b)'s first port-trained NN as the incumbent of a
    600-column set, served by a fleet on the card under a client; one
    breach through a window of P17_NN_ROWS fresh rows trains it two
    epochs on, guards (K1 twice), publishes and swaps in place with no
    new capture; every answer is wholly the old or the new model's;
    the guardrail's AUCs are within 1e-5 of a CPU twin's."""
    import threading

    from shifu_tpu_torch import registry
    from shifu_tpu_torch.data import reader
    from shifu_tpu_torch.obs.health.refresh import RefreshController
    from shifu_tpu_torch.processor.base import ProcessorContext
    from shifu_tpu_torch.serve.fleet import FleetService
    from shifu_tpu_torch.serve.service import ScorerService
    ms = p17_nn_set(os.path.join(workdir, "p17_nn"), swap_dirs[0], 173,
                    device)
    twin = _set_copy(ms, os.path.join(workdir, "p17_nn_cpu"))
    names, tokens = nn_raw_table(np.random.default_rng(174), P17_NN_ROWS)
    window = reader._rows_table(["|".join(r) for r in tokens.tolist()],
                                names, "|", "window")
    reg = os.path.join(workdir, "p17_nn_reg")
    reg_cpu = os.path.join(workdir, "p17_nn_reg_cpu")
    registry.publish(reg, "nn", os.path.join(ms, "models"))
    registry.publish(reg_cpu, "nn", os.path.join(twin, "models"))
    rng = np.random.default_rng(175)
    reqs = [{"dense": rng.normal(0, 1, (n, NN_IN)).astype(np.float32)}
            for n in (1, 3, 8, 40, 64, 300, 512)]

    def eager_scores(vdir):
        with ScorerService(models_dir=vdir, device=device,
                           graphs=False) as ref:
            return [ref.submit(timeout=120, **r)["mean"] for r in reqs]
    old = eager_scores(registry.resolve(reg, "nn")[1])
    fleet = FleetService(reg, workspace_root=ms, device=device,
                         slo_p99_ms=1e9)
    ctl = RefreshController(ProcessorContext.load(ms), registry_root=reg,
                            model_name="nn", fleet=fleet,
                            tolerance=P17_TOLERANCE, cooldown_s=0.0,
                            device=device)
    ctl.note_window(window)

    def cpu():
        c = RefreshController(ProcessorContext.load(twin),
                              registry_root=reg_cpu, model_name="nn",
                              tolerance=P17_TOLERANCE, cooldown_s=0.0,
                              device="cpu")
        c.note_window(window)
        return c.handle_breach({"slo": "drift", "state": "breach"}), c

    def card():
        for r in reqs:
            fleet.submit("nn", timeout=120, **r)
        svc = fleet._entries["nn"].service
        caps = svc.graph_captures
        stop, failures, answers = threading.Event(), [], []
        t = threading.Thread(target=_client, args=(fleet, "nn", reqs, stop,
                                                   failures, answers))
        t.start()
        try:
            outcome = ctl.handle_breach({"slo": "drift", "state": "breach"})
            time.sleep(0.2)
        finally:
            stop.set()
            t.join()
        assert fleet._entries["nn"].service is svc, "the service was replaced"
        return outcome, caps, svc.graph_captures, failures, answers
    t0 = time.monotonic()
    try:
        (outcome, caps, caps_after, failures, answers), \
            (cpu_outcome, cpu_ctl) = card_beside_cpu(card, cpu)
        wall = time.monotonic() - t0
        assert outcome == "promoted" == cpu_outcome, \
            (ctl.stats(), cpu_ctl.stats())
        assert registry.head(reg, "nn") == "v002"
        assert fleet.stats()["fleet"]["swaps"] == 1
        assert caps_after == caps, (caps, caps_after)
        new = eager_scores(registry.resolve(reg, "nn")[1])
        assert not failures and answers, failures[:3]
        seen = [0, 0]
        for j, got in answers:
            hit = [np.array_equal(got, old[j]), np.array_equal(got, new[j])]
            assert any(hit), f"request {j}: neither old nor new scores"
            seen[hit.index(True)] += 1
        assert seen[1] > 0, seen
        for j, r in enumerate(reqs):
            assert np.array_equal(fleet.submit("nn", timeout=120, **r)
                                  ["mean"], new[j]), j
    finally:
        fleet.close()
    man = registry.resolve(reg, "nn")[2]["refresh"]
    cpu_man = registry.resolve(reg_cpu, "nn")[2]["refresh"]
    auc_err = max(abs(man[k] - cpu_man[k])
                  for k in ("incumbent_auc", "challenger_auc"))
    assert auc_err <= 1e-5, (man, cpu_man)
    out = {"wall_s": wall, "answers_old_new": seen, "captures": caps,
           "incumbent_auc": man["incumbent_auc"],
           "challenger_auc": man["challenger_auc"], "cpu_auc_err": auc_err}
    print(f"  (c) NN refresh: {json.dumps(out)}")
    return out


_P17_KILL = """\
import sys
sys.path.insert(0, sys.argv[4])
from shifu_tpu_torch.obs.health.canary import CanaryController
from shifu_tpu_torch.serve.fleet import FleetService
reg, chal, store_root = sys.argv[1:4]
with FleetService(reg, workspace_root=store_root,
                  device=sys.argv[5]) as fleet:
    CanaryController(fleet, reg, "canary_nn", store_root=store_root,
                     shadow_pct=0.5, canary_pct=0.2, min_requests=10**6,
                     window_s=600.0).run(chal, "kill01")
raise SystemExit("the canary ended before it was killed")
"""


def p17_canary(workdir, swap_dirs, store_root, device="cuda"):
    """(d) Phase 16 (b)'s two NNs as incumbent and challenger in a fleet
    under mixed traffic: `CanaryController` (shadow 0.5, canary 0.2,
    min_requests 32) promotes; the arm captured its graphs at
    `start_arms` only, HEAD is the challenger and the fleet answers like
    a standalone challenger service, bit for bit. Then a challenger made
    slow (each of its requests held 60 ms) rolls back mid-canary to the
    baseline (`p17_kill_*` is the SIGKILL drill)."""
    import threading

    from shifu_tpu_torch import registry
    from shifu_tpu_torch.obs.health.canary import (CanaryController,
                                                   read_state)
    from shifu_tpu_torch.serve.fleet import FleetService
    from shifu_tpu_torch.serve.service import ScorerService
    reg = os.path.join(workdir, "p17_canary_reg")
    assert registry.publish(reg, "canary_nn", swap_dirs[0]) == "v001"
    rng = np.random.default_rng(176)
    reqs = [{"dense": rng.normal(0, 1, (n, NN_IN)).astype(np.float32)}
            for n in (1, 2, 5, 8, 16, 33, 64, 128)]
    fleet = FleetService(reg, workspace_root=store_root, device=device,
                         slo_p99_ms=1e9)
    arm_caps, slow = [], {"s": 0.0}
    start, stop_arms = fleet.start_arms, fleet.stop_arms

    def start_watched(name, challenger_dir, **kw):
        out = start(name, challenger_dir, **kw)
        svc = fleet._arms[name].service
        arm_caps.append([svc.graph_captures, None])
        if slow["s"]:
            submit = svc.submit_timed

            def slow_submit(timeout=30.0, **blocks):
                time.sleep(slow["s"])
                got, timing = submit(timeout=timeout, **blocks)
                timing["total_s"] += slow["s"]
                return got, timing
            svc.submit_timed = slow_submit
        return out

    def stop_watched(name):
        arm = fleet._arms.get(name)
        if arm is not None and arm_caps:
            arm_caps[-1][1] = arm.service.graph_captures
        return stop_arms(name)
    fleet.start_arms, fleet.stop_arms = start_watched, stop_watched
    # the PSI band wide open, as in the JAX package's drills: two NNs
    # from two seeds put their scores in other 16-bin buckets (the rule
    # itself is held against the JAX package's on the CPU)
    kw = dict(shadow_pct=0.5, canary_pct=0.2, min_requests=32,
              window_s=30.0, psi_max=100.0, slo_p99_ms=50.0, poll_s=0.01)

    def under_traffic(fn):
        stop, failures, answers = threading.Event(), [], []
        clients = [threading.Thread(target=_client, args=(
            fleet, "canary_nn", reqs[i::2], stop, failures, answers))
            for i in range(2)]
        for c in clients:
            c.start()
        try:
            return fn(), failures, len(answers)
        finally:
            stop.set()
            for c in clients:
                c.join()
    out = {}
    try:
        for r in reqs:
            fleet.submit("canary_nn", timeout=120, **r)
        primary = fleet._entries["canary_nn"].service
        caps = primary.graph_captures
        t0 = time.monotonic()
        res, failures, served = under_traffic(lambda: CanaryController(
            fleet, reg, "canary_nn", store_root=store_root, **kw).run(
                swap_dirs[1], "canary01"))
        out["promote_s"] = time.monotonic() - t0
        assert res["outcome"] == "promoted", res
        assert not failures and served > 0, failures[:3]
        assert registry.head(reg, "canary_nn") == res["version"] == "v002"
        assert len(arm_caps) == 1 and arm_caps[0][0] == arm_caps[0][1] \
            and (arm_caps[0][0] > 0 or device != "cuda"), arm_caps
        assert fleet._entries["canary_nn"].service is primary and \
            primary.graph_captures == caps and res["swap"] == "swapped", \
            (res["swap"], caps, primary.graph_captures)
        with ScorerService(models_dir=swap_dirs[1], device=device) as solo:
            for r in reqs:
                assert same_scores(fleet.submit("canary_nn", timeout=120,
                                                **r),
                                   solo.submit(timeout=120, **r))
        win = res["verdict"]["live_window"]
        out.update(served=served, version=res["version"],
                   requests=win["requests"], arm_psi=win["arm_psi"],
                   p99_ms=win["p99_ms"], arm_captures=arm_caps[0][0])
        # a slow challenger breaches the live band and rolls back
        slow["s"] = 0.06
        t0 = time.monotonic()
        res, failures, served = under_traffic(lambda: CanaryController(
            fleet, reg, "canary_nn", store_root=store_root,
            **dict(kw, slo_p99_ms=20.0)).run(swap_dirs[0], "canary02"))
        out["rollback_s"] = time.monotonic() - t0
        assert res["outcome"] == "rolled_back" and \
            "p99" in res["verdict"]["reason"], res
        assert not failures and served > 0, failures[:3]
        assert registry.head(reg, "canary_nn") == "v002"
        assert read_state(reg, "canary_nn") is None
        assert arm_caps[1][0] == arm_caps[1][1], arm_caps
        out["rolled_back"] = {"version": res["version"],
                              "reason": res["verdict"]["reason"]}
    finally:
        fleet.close()
    assert not _tmp_residue(reg)
    print(f"  (d) canary: {json.dumps(out)}")
    return out


def p17_kill_start(workdir, swap_dirs, store_root, device="cuda"):
    """Start (d)'s last drill early: a process serving `canary_nn` (phase
    16 (b)'s first NN, a registry of its own) that runs a canary of the
    second NN and waits in its shadow phase for a quorum it never gets."""
    from shifu_tpu_torch import registry
    reg = os.path.join(workdir, "p17_kill_reg")
    v1 = registry.publish(reg, "canary_nn", swap_dirs[0])
    proc = _spawn(["-c", _P17_KILL, reg, swap_dirs[1], store_root,
                   os.path.dirname(os.path.abspath(__file__)), device])
    return proc, reg, v1


def p17_kill_finish(proc, reg, v1, store_root, device="cuda"):
    """SIGKILL that process in its shadow phase (HEAD then names the
    challenger it published), then `watch --registry` on the card rolls
    HEAD back to the baseline through `CanaryController.recover` and
    clears CANARY.json."""
    import contextlib
    import io

    from shifu_tpu_torch import cli, registry
    from shifu_tpu_torch.obs.health.canary import read_state
    try:
        deadline = time.monotonic() + 300
        while (read_state(reg, "canary_nn") or {}).get("phase") != "shadow":
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            assert time.monotonic() < deadline, "no shadow phase"
            time.sleep(0.1)
        state = read_state(reg, "canary_nn")
        proc.kill()
        proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == -9, proc.returncode
    assert registry.head(reg, "canary_nn") == state["version"] == "v002"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--dir", store_root, "watch", "--monitor-only",
                       "--registry", reg, "--model-name", "canary_nn",
                       "--iterations", "1", "--interval-s", "0",
                       "--device", device])
    assert rc == 0 and read_state(reg, "canary_nn") is None
    assert registry.head(reg, "canary_nn") == v1
    assert registry.resolve(reg, "canary_nn", "v002")[2]["canary"][
        "verdict"] == "rollback"
    assert not _tmp_residue(reg)
    out = {"phase": state["phase"], "version": state["version"],
           "recovered_to": v1}
    print(f"  (d) killed canary: {json.dumps(out)}")
    return out


def p17_cli_start(card_root, cpu_root, pristine, device="cuda"):
    """(e) `watch --ingest LOG --registry R --model-name gbt --iterations
    3` as a process on the card and its `--device cpu` twin, each over
    its own copy of the set, the log and the registry."""
    import shutil

    from shifu_tpu_torch import registry
    procs, regs = [], []
    for root, dev in ((card_root, device), (cpu_root, "cpu")):
        log = shutil.copytree(pristine, root + "_log")
        reg = root + "_reg"
        registry.publish(reg, "gbt", os.path.join(root, "models"))
        regs.append(reg)
        procs.append(_spawn(
            ["-m", "shifu_tpu_torch", "--dir", root, "watch", "--ingest",
             log, "--registry", reg, "--model-name", "gbt", "--iterations",
             "3", "--interval-s", "0", "--device", dev],
            dict(CPU_TWIN_ENV if dev == "cpu" else {},
                 SHIFU_TPU_REFRESH_TOLERANCE=str(P17_TOLERANCE))))
    return procs, regs


def p17_cli_finish(procs, regs, card_root):
    """(e)'s two processes end with the same decision and AUCs within
    1e-6; then `health` over the card's set shows its refresh events and
    the canary arms' lines (the canaries of (d) record there)."""
    import contextlib
    import io

    from shifu_tpu_torch import cli, registry
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    mans = [registry.resolve(reg, "gbt")[2].get("refresh") for reg in regs]
    heads = [registry.head(reg, "gbt") for reg in regs]
    assert heads[0] == heads[1] == "v002" and all(mans), (heads, mans)
    auc_err = max(abs(mans[0][k] - mans[1][k])
                  for k in ("incumbent_auc", "challenger_auc"))
    assert auc_err <= 1e-6, mans
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--dir", card_root, "health"])
    text = buf.getvalue()
    assert "canary arms:" in text and "  canary_nn: phase=" in text and \
        "event.refresh" in text, text
    out = {"heads": heads, "cpu_auc_err": auc_err, "health_rc": rc,
           "health_lines": [ln for ln in text.splitlines()
                            if "canary" in ln or "refresh" in ln]}
    print(f"  (e) watch --ingest CLI: {json.dumps(out)}")
    return out


def phase_closed_loop(report, workdir, swap_dirs, device="cuda"):
    """Phase 17, the closed loop on the card over phase 16's artifacts:
    (a) the row log, (b) the GBT refresh, (c) the NN refresh, (d) the
    canary, (e) full `watch --ingest` as processes. Its K1, K2, K3 and
    K5 launches join the kernels line."""
    from shifu_tpu_torch.ops import best_splits, fused_score, fused_trees
    from shifu_tpu_torch.ops import level_hist
    t0 = time.monotonic()
    health = os.path.join(workdir, "health")
    keys = ("SHIFU_TPU_METRICS", "SHIFU_TPU_INGEST_SEGMENT_ROWS",
            "SHIFU_TPU_FAULT")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(SHIFU_TPU_METRICS="1",
                      SHIFU_TPU_INGEST_SEGMENT_ROWS=str(P17_SEG_ROWS))
    fused_score.launches = fused_trees.launches = 0
    level_hist.launches = best_splits.launches = 0
    out, procs = {}, []
    try:
        # processes that start long before they are read: (a)'s `ingest
        # ls`, (b) and (d)'s canary to be killed
        log_root, pristine, out["ingest"], ls = p17_ingest(workdir, health)
        gbt = p17_gbt_start(workdir, swap_dirs[1], device)
        procs += [ls, gbt]
        e_card = _set_copy(health, os.path.join(workdir, "p17_e_card"))
        e_cpu = _set_copy(health, os.path.join(workdir, "p17_e_cpu"))
        kill = p17_kill_start(workdir, swap_dirs, e_card, device)
        procs.append(kill[0])
        out["nn"] = p17_nn_refresh(workdir, swap_dirs, device)
        out["gbt"] = p17_gbt_finish(gbt)
        p17_ingest_ls(ls, out["ingest"])
        out["canary"] = p17_canary(workdir, swap_dirs, e_card, device)
        out["canary"]["killed"] = p17_kill_finish(*kill, e_card, device)
        # after the canaries, so the refresh is the newest health event
        cli_procs, regs = p17_cli_start(e_card, e_cpu, pristine, device)
        procs += cli_procs
        out["cli"] = p17_cli_finish(cli_procs, regs, e_card)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launched = {"fused_score": fused_score.launches,
                "fused_trees": fused_trees.launches,
                "level_hist": level_hist.launches,
                "best_splits": best_splits.launches}
    for k, v in out["gbt"]["process_launches"].items():
        launched[k] += v
    for k in ("fused_score", "fused_trees", "level_hist", "best_splits"):
        assert launched[k] > 0, f"phase 17 launched no {k}: {launched}"
        report[k]["launches"] += launched[k]
    out["launches"] = launched
    out["seconds"] = time.monotonic() - t0
    report["p17"] = out
    print(f"  phase 17: {out['seconds']:.1f} s, launches "
          f"{json.dumps(launched)}")


# ---------------------------------------------------------------------------
# phase 18: checkpoints and resume
# ---------------------------------------------------------------------------

P18_ROWS = 8_192            # the 600-column NN table of phase 16 (b)
P18_EPOCHS, P18_INTERVAL = 12, 4
P18_STREAM_EPOCHS, P18_CHUNK = 6, 2_048   # (c): 4 chunks an epoch
P18_PARAMS = {"NumHiddenLayers": 2, "NumHiddenNodes": list(NN_HIDDEN),
              "ActivationFunc": ["relu", "relu"], "Propagation": "ADAM",
              "LearningRate": 0.002, "DropoutRate": 0.1,
              "CheckpointInterval": P18_INTERVAL}
# the uninterrupted twins train straight through, with no checkpoint:
# a chunked run is held against an unchunked one
P18_STRAIGHT = dict(P18_PARAMS, CheckpointInterval=0)


@contextlib.contextmanager
def port_log():
    """The messages the port logs (INFO and up) while the block runs."""
    import logging

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())
    logger = logging.getLogger("shifu_tpu_torch")
    handler, level = Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def cli_rc(root, *args):
    """`cli.main` in process, its stdout swallowed; returns the rc."""
    import io
    from shifu_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(["--dir", root, *args])


def _nn_arrays(root):
    from shifu_tpu_torch.models.spec import load_model
    return [v for layer in load_model(os.path.join(root, "models",
                                                   "model0.nn"))[2]
            for v in layer.values()]


def same_nn(a, b):
    """Whether two sets' models/model0.nn hold equal arrays, bit for bit."""
    pa, pb = _nn_arrays(a), _nn_arrays(b)
    return len(pa) == len(pb) and all(np.array_equal(x, y)
                                      for x, y in zip(pa, pb))


def p18_nn_set(root, device="cuda"):
    """The checkpointed NN's set: a P18_ROWS-row raw table of 600
    columns (eval set Eval1 on the same rows), the serving NN's shape
    600 → 512 → 256 → 1 (ADAM, dropout 0.1, P18_EPOCHS epochs,
    CheckpointInterval 4), `init`, `stats` and `norm` on `device` in
    process; `norm` runs with trainOnDisk, so it writes data.npz and the
    `.npy` layout at once (the resident copies turn it off)."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    names, tokens = nn_raw_table(np.random.default_rng(181), P18_ROWS)
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, names, tokens)
    data_set = {"dataPath": data_dir, "dataDelimiter": "|",
                "headerPath": os.path.join(data_dir, ".pig_header"),
                "targetColumnName": "label", "posTags": ["1"],
                "negTags": ["0"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeCheckpoint"}, "dataSet": data_set,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": {"algorithm": "NN", "numTrainEpochs": P18_EPOCHS,
                  "baggingNum": 1, "validSetRate": 0.1, "trainOnDisk": True,
                  "params": dict(P18_PARAMS)},
        "evals": [{"name": "Eval1", "dataSet": data_set}]}).save(root)
    lines = run_verbs([(root, [v]) for v in ("init", "stats", "norm")],
                      device)
    assert all(ln["rc"] == 0 for ln in lines), lines
    return root


def p18_copy(base, dst, **train):
    root = _set_copy(base, dst)
    set_config(root, "train", **train)
    return root


def p18_save_timing(kill, device="cuda"):
    """One checkpoint of the full-width carry, timed: the step's arrays
    back on `device`, a synchronous `save_state` (snapshot, serialize,
    publish) and an async `save_checkpoint` (the stall the epoch loop
    waits, then the flush). Returns seconds and the snapshot's bytes."""
    import shutil

    import torch
    from shifu_tpu_torch.train import checkpoint as ckpt
    src = os.path.join(kill, "tmp", "checkpoints", "bag0",
                       f"step_{P18_EPOCHS}.npz")
    with np.load(src) as z:
        # the arrays (the generator's device-type string aside)
        state = {k: torch.from_numpy(z[k]).to(device) for k in z.files
                 if k != "__header__" and z[k].dtype.kind not in "US"}
    d = os.path.join(os.path.dirname(kill), "p18_timing")
    out = {"snapshot_bytes": int(sum(t.numel() * t.element_size()
                                     for t in state.values()))}
    for step in (1, 2):       # the first pays the writer's warm-up
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_state(d, step, state)
        out["sync_save_s"] = time.perf_counter() - t0
    with _environ({"SHIFU_TPU_CKPT_ASYNC": "1"}):
        t0 = time.perf_counter()
        ckpt.save_checkpoint(d, 3, state)
        out["async_stall_s"] = time.perf_counter() - t0
        ckpt.flush_saves()
        out["async_save_s"] = time.perf_counter() - t0
    shutil.rmtree(d)
    return out


def p18_spawn(args, log_path, env_extra=None):
    """`python <args>` from the repo's root: stdout piped, stderr (the
    port's log) into `log_path`, so a long log never blocks it."""
    env = dict(os.environ)
    env.update(env_extra or {})
    with open(log_path, "w") as err:
        return subprocess.Popen(
            [sys.executable, *args], stdout=subprocess.PIPE, stderr=err,
            text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))


def _log_tail(path, n=3000):
    with open(path) as f:
        return f.read()[-n:]


def p18_kill_resume(proc, kill, twin, t_line, device="cuda"):
    """(a) after the SIGKILLed `train` process: rc -SIGKILL, `ckpt`
    reports step 8 and the one-card sidecar, no `.tmp` residue; the
    resume (SHIFU_TPU_RESUME=1, in process) logs epoch 8 and ends on
    the uninterrupted twin's model, best validation error and the
    curves of the epochs after the resume, bit for bit; `eval` of both
    through K1: AUCs within 1e-6."""
    import io
    import signal
    from shifu_tpu_torch import cli
    proc.communicate(timeout=600)
    assert proc.returncode == -signal.SIGKILL, \
        f"the killed train ended rc {proc.returncode}:\n" \
        + _log_tail(kill + ".log")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--dir", kill, "ckpt"]) == 0
    rec = json.loads(buf.getvalue())["checkpoints"]
    assert len(rec) == 1 and rec[0]["latestStep"] == 2 * P18_INTERVAL, rec
    sharding = rec[0]["sharding"]
    assert sharding["mesh"] == {"axes": ["data", "model"], "shape": [1, 1],
                                "devices": 1, "hosts": 1} and \
        sharding["shardedLeaves"] == 0 and sharding["deviceLeaves"] > 0, rec
    assert not _tmp_residue(kill), _tmp_residue(kill)
    with _environ({"SHIFU_TPU_RESUME": "1"}), port_log() as logs:
        r_line = run_verbs([(kill, ["train"])], device)[0]
    assert r_line["rc"] == 0, r_line
    assert any("resumed at epoch 8" in m for m in logs), logs[-20:]
    assert same_nn(kill, twin), "the resumed model differs from the twin's"
    with open(os.path.join(kill, "tmp", "valerr.json")) as f:
        got = json.load(f)
    with open(os.path.join(twin, "tmp", "valerr.json")) as f:
        want = json.load(f)
    assert got["bestValError"] == want["bestValError"], (got, want)
    after = [row[2 * P18_INTERVAL:] for row in t_line["val_errors"]]
    assert r_line["val_errors"] == after, (r_line["val_errors"], after)
    assert got["bestEpoch"] == [int(np.argmin(row)) for row in after]
    evals = run_verbs([(kill, ["eval"]), (twin, ["eval"])], device)
    auc = []
    for root in (kill, twin):
        with open(os.path.join(root, "evals", "Eval1",
                               "EvalPerformance.json")) as f:
            auc.append(json.load(f)["areaUnderRoc"])
    assert abs(auc[0] - auc[1]) <= 1e-6, auc
    k1 = sum(ln["launches"]["fused_score"] for ln in evals)
    if device == "cuda":
        assert all(ln["launches"]["fused_score"] > 0 for ln in evals), evals
    return {"killed_rc": proc.returncode, "ckpt": rec[0],
            "best_val": got["bestValError"], "auc": auc,
            "auc_err": abs(auc[0] - auc[1]), "k1": k1,
            "twin_train_s": t_line["seconds"],
            "resume_s": r_line["seconds"],
            "save": p18_save_timing(kill, device)}


def p18_preempt(workdir, base, twin, device="cuda"):
    """(b) A preemption after the first save (epoch 4: the saves are
    synchronous, so `ckpt.saved` fires on the training thread and the
    epoch loop sees it at that boundary): supervised (2 restarts) it
    restarts once, recorded in steps.jsonl (a durable `restart` line,
    and the step's own record counting it), and ends on (a)'s
    unchunked twin's model; unsupervised `train` returns 75, and the
    rerun with SHIFU_TPU_RESUME=1 returns 0 with the same model."""
    sup = p18_copy(base, os.path.join(workdir, "p18_sup"),
                   trainOnDisk=False)
    with _environ({"SHIFU_TPU_FAULT": "ckpt.saved:preempt:1",
                   "SHIFU_TPU_MAX_RESTARTS": "2",
                   "SHIFU_TPU_CKPT_ASYNC": "0"}):
        line = run_verbs([(sup, ["train"])], device)[0]
    assert line["rc"] == 0, line
    with open(os.path.join(sup, "tmp", "metrics", "steps.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    events = [r for r in recs if "event" in r]
    assert [r["event"] for r in events] == ["restart"], recs
    train = [r for r in recs if r["step"] == "train" and "event" not in r]
    assert train[-1]["rc"] == 0 and train[-1]["restarts"] == 1, train
    assert same_nn(sup, twin), "the supervised run's model differs"
    solo = p18_copy(base, os.path.join(workdir, "p18_solo"),
                    trainOnDisk=False)
    with _environ({"SHIFU_TPU_FAULT": "ckpt.saved:preempt:1",
                   "SHIFU_TPU_CKPT_ASYNC": "0"}):
        rc = cli_rc(solo, "train", "--device", device)
    from shifu_tpu_torch.train import checkpoint as ckpt
    step = ckpt.latest_step(os.path.join(solo, "tmp", "checkpoints", "bag0"))
    assert rc == 75 and step == P18_INTERVAL, (rc, step)
    with _environ({"SHIFU_TPU_RESUME": "1"}):
        rc2 = cli_rc(solo, "train", "--device", device)
    assert rc2 == 0 and same_nn(solo, twin), rc2
    return {"restart": events[0], "unsupervised_rc": [rc, rc2],
            "preempted_at": step}


def p18_streaming(workdir, base, device="cuda"):
    """(c) The streaming NN over (a)'s `.npy` layout, ChunkRows
    P18_CHUNK, CheckpointInterval 1: a preemption at the 2nd
    (synchronous) save returns 75, the resume from epoch 2 returns 0,
    with the model of an uninterrupted streaming run that saved no
    checkpoint; the route's checkpoints are gone once the model is
    saved."""
    fields = {"numTrainEpochs": P18_STREAM_EPOCHS, "params": dict(
        P18_PARAMS, ChunkRows=P18_CHUNK, CheckpointInterval=1)}
    pre = p18_copy(base, os.path.join(workdir, "p18_stream"), **fields)
    fields["params"] = dict(fields["params"], CheckpointInterval=0)
    twin = p18_copy(base, os.path.join(workdir, "p18_stream_twin"), **fields)
    assert cli_rc(twin, "train", "--device", device) == 0
    with _environ({"SHIFU_TPU_FAULT": "ckpt.saved:preempt:2",
                   "SHIFU_TPU_CKPT_ASYNC": "0"}):
        rc = cli_rc(pre, "train", "--device", device)
    ck = os.path.join(pre, "tmp", "checkpoints", "bag0", "streaming")
    from shifu_tpu_torch.train import checkpoint as ckpt
    step = ckpt.latest_step(ck)
    with _environ({"SHIFU_TPU_RESUME": "1"}), port_log() as logs:
        rc2 = cli_rc(pre, "train", "--device", device)
    assert rc == 75 and rc2 == 0 and step == 2, (rc, rc2, step)
    assert any(f"resumed from checkpoint at epoch {step}" in m
               for m in logs), logs[-20:]
    assert same_nn(pre, twin), "the resumed streaming model differs"
    assert not os.path.exists(ck), os.listdir(ck)
    return {"rc": [rc, rc2], "resumed_at": step}


def p18_gbt_main(workdir, device):
    """The `--p18-gbt` process, (d): phase 16 (d)'s GBT set copied;
    `stats → norm → train → eval` write their manifests; with
    SHIFU_TPU_RESUME=1 every step logs its skip and no K2, K3 or K5
    runs between marker kernels; after a newline appended to
    ModelConfig.json `train` and `eval` re-run (K3 +25, K5 +20 between
    markers, K2 again) to the same scores; `norm` failing at its first
    atomic commit leaves no manifest and meta.json as it was, and a
    clean rerun passes. The last line holds the result."""
    from shifu_tpu_torch.ops import best_splits, fused_trees, level_hist
    root = _set_copy(os.path.join(workdir, "health"),
                     os.path.join(workdir, "p18_gbt"))
    steps = ("stats", "norm", "train", "eval")
    first = run_verbs([(root, [s]) for s in steps], device)
    assert all(ln["rc"] == 0 for ln in first), first
    mdir = os.path.join(root, "tmp", "manifests")
    assert sorted(os.listdir(mdir)) == ["eval.holdout.json", "norm.json",
                                        "stats.json", "train.json"], \
        os.listdir(mdir)
    score = os.path.join(root, "evals", "holdout", "EvalScore.csv")
    with open(score, "rb") as f:
        scores = f.read()

    def counted(fn):
        if device != "cuda":
            fn()
            return {}
        names = kernels_between_markers(fn)
        return {"K2": count_kernels(names, "fused_trees"),
                "K3": count_kernels(names, "level_hist"),
                "K5": count_kernels(names, "best_splits")}
    box = {}
    with _environ({"SHIFU_TPU_RESUME": "1"}), port_log() as logs:
        skipped = counted(lambda: box.update(
            skip=run_verbs([(root, [s]) for s in steps], device)))
    skips = [m.split(":")[0] for m in logs if "skipping" in m]
    assert skips == ["step stats", "step norm", "step train",
                     "step eval.holdout"], logs[-20:]
    assert all(ln["rc"] == 0 for ln in box["skip"])
    if device == "cuda":
        assert skipped == {"K2": 0, "K3": 0, "K5": 0}, skipped
    with open(os.path.join(root, "ModelConfig.json"), "a") as f:
        f.write("\n")
    with _environ({"SHIFU_TPU_RESUME": "1"}), port_log() as logs:
        rerun = counted(lambda: box.update(
            rerun=run_verbs([(root, ["train"]), (root, ["eval"])], device)))
    assert sum("re-running" in m for m in logs) == 2, logs[-20:]
    if device == "cuda":
        assert rerun["K3"] == 25 and rerun["K5"] == 20 and \
            rerun["K2"] > 0, rerun
    with open(score, "rb") as f:
        assert f.read() == scores, "the re-run's scores differ"
    meta = os.path.join(root, "tmp", "NormalizedData", "meta.json")
    with open(meta, "rb") as f:
        meta_bytes = f.read()
    with _environ({"SHIFU_TPU_FAULT": "atomic.commit:oserror:1"}):
        try:
            cli_rc(root, "norm", "--device", device)
        except OSError as e:
            failed = str(e)
        else:
            raise AssertionError("norm passed its injected commit fault")
    assert not os.path.exists(os.path.join(mdir, "norm.json"))
    with open(meta, "rb") as f:
        assert f.read() == meta_bytes, "meta.json changed"
    assert cli_rc(root, "norm", "--device", device) == 0
    assert os.path.exists(os.path.join(mdir, "norm.json"))
    lines = first + box["rerun"]
    kinds = ("fused_trees", "level_hist", "best_splits")
    print(json.dumps({
        "skipped": skipped, "rerun": rerun, "norm_fault": failed,
        "launches": {k: sum(ln.get("launches", {}).get(k, 0)
                            for ln in lines) for k in kinds},
        "process_launches": {"fused_trees": fused_trees.launches,
                             "level_hist": level_hist.launches,
                             "best_splits": best_splits.launches}}))


def phase_checkpoint_resume(report, workdir, device="cuda"):
    """Phase 18, checkpoints and resume on the card, in phase 16's work
    directory: (a) a full-width NN `train` SIGKILLed after its 2nd
    save, resumed to the uninterrupted twin's model; (b) a preemption,
    supervised and not; (c) the streaming NN preempted and resumed; (d)
    the manifests on phase 16's GBT set, in a process of its own
    (`--p18-gbt`, started first, as the killed `train` is: both run
    while (b) and (c) run here). Its K1, K2, K3 and K5 launches join
    the kernels line."""
    t0 = time.monotonic()
    gbt_log = os.path.join(workdir, "p18_gbt.log")
    procs = [p18_spawn([os.path.abspath(__file__), "--p18-gbt", workdir,
                        device], gbt_log)]
    out = {}
    try:
        base = p18_nn_set(os.path.join(workdir, "p18_base"), device)
        kill = p18_copy(base, os.path.join(workdir, "p18_kill"),
                        trainOnDisk=False)
        procs.append(p18_spawn(
            ["-m", "shifu_tpu_torch", "--dir", kill, "train", "--device",
             device], kill + ".log", {"SHIFU_TPU_FAULT": "ckpt.saved:kill:2",
                                      "SHIFU_TPU_CKPT_ASYNC": "1"}))
        twin = p18_copy(base, os.path.join(workdir, "p18_twin"),
                        trainOnDisk=False, params=P18_STRAIGHT)
        t_line = run_verbs([(twin, ["train"])], device)[0]
        assert t_line["rc"] == 0, t_line
        out["b"] = p18_preempt(workdir, base, twin, device)
        out["c"] = p18_streaming(workdir, base, device)
        out["a"] = p18_kill_resume(procs[1], kill, twin, t_line, device)
        res, _ = procs[0].communicate(timeout=600)
        assert procs[0].returncode == 0, \
            "--p18-gbt failed:\n" + _log_tail(gbt_log)
        out["d"] = json.loads(res.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    launched = {"fused_score": out["a"]["k1"]}
    launched.update(out["d"]["launches"])
    for k, v in launched.items():
        if device == "cuda":
            assert v > 0, f"phase 18 launched no {k}: {launched}"
        report[k]["launches"] += v
    out["launches"] = launched
    out["seconds"] = time.monotonic() - t0
    report["p18"] = out
    for part in "abcd":
        print(f"  ({part}) {json.dumps(out[part])}")
    print(f"  phase 18: {out['seconds']:.1f} s, launches "
          f"{json.dumps(launched)}")


# ---------------------------------------------------------------------------
# phase 19: the pipeline DAG, the segment siblings, combo and test
# ---------------------------------------------------------------------------

P19_ROWS = 65_536           # the HIGGS-width table of phase 10's layout
P19_EVAL_ROWS = 16_384      # its eval file (eval sets Eval1 and Eval2)
P19_PARAMS = {"TreeNum": 20, "MaxDepth": TRAIN_DEPTH,
              "LearningRate": TRAIN_LR, "Loss": "log",
              # combo's NN sub-model: the flagship's hidden width
              # (bench.py:76-78)
              "NumHiddenLayers": 1, "NumHiddenNodes": [64],
              "ActivationFunc": ["relu"], "Propagation": "ADAM"}
P19_EPOCHS = 10
P19_SEGMENTS = ("f0 > 0", "c0 == 'aa'")
P19_DEPS = {"test.config": [], "test.filter": ["test.config"],
            "test.eval.Eval1": ["test.config"],
            "test.eval.Eval2": ["test.config"],
            "test.plan": ["test.config"]}
P19_KERNELS = ("fused_score", "fused_trees", "level_hist", "best_splits")
# combo's assemble scores, card against CPU (phase 15's score gate)
P19_SCORE_TOL = 1e-5
# the nodes posttrain's rewrite of ColumnConfig.json can leave stale
# (C-ref-4): a RESUME run may run these again, and no other
P19_STALE = ("stats", "norm", "train.GBT", "eval.Eval1", "eval.Eval2")
# the kernels phase 19's path launches: combo scores its sub-models
# through `ModelRunner.score_frame`, which (as the JAX package's) passes
# no z-score parameters, so its NN sub-model takes the plain forward and
# K1 (`fused_score`) is counted but not required
P19_PATH = ("fused_trees", "level_hist", "best_splits")


def p19_set(root, eval_dir, seed=191):
    """Phase 19's model set: a P19_ROWS-row raw table of phase 10's
    layout (28 numeric, 2 categorical, weight and meta columns) from a
    seed, GBT at phase 8's widths, eval sets Eval1 and Eval2 over
    `eval_dir`'s P19_EVAL_ROWS rows (written once, by the first call)."""
    write_model_set(root, "GBT", dict(P19_PARAMS), seed, P19_ROWS, 0.1,
                    extras=True)
    set_config(root, "train", numTrainEpochs=P19_EPOCHS)
    if not os.path.exists(eval_dir):
        names, cols, _, _ = raw_table(np.random.default_rng(seed + 1),
                                      P19_EVAL_ROWS, True)
        write_raw(eval_dir, names, cols)
    for name in ("Eval1", "Eval2"):
        add_eval_set(root, name, eval_dir)
    return root


def p19_outputs(root, clone=None):
    """{relative path: bytes} of what the pipeline published:
    ColumnConfig.json, the normalized and cleaned data, the models,
    each eval set's EvalPerformance.json, featureimportance.csv, and
    the RF clone's model."""
    files = ["ColumnConfig.json", "featureimportance.csv",
             "models/model0.gbt", "evals/Eval1/EvalPerformance.json",
             "evals/Eval2/EvalPerformance.json"]
    for sub in ("NormalizedData", "CleanedData"):
        files += [f"tmp/{sub}/{f}" for f in
                  sorted(os.listdir(os.path.join(root, "tmp", sub)))]
    out = {}
    for rel in files:
        with open(os.path.join(root, rel), "rb") as f:
            out[rel] = f.read()
    if clone:
        with open(os.path.join(clone, "models", "model0.rf"), "rb") as f:
            out["train.RF:models/model0.rf"] = f.read()
    return out


def p19_log_launches(*roots):
    """The kernels' launches the DAG's child processes report: the sum
    of every step line's ``launches`` in each root's tmp/dag_logs/*.log."""
    total = dict.fromkeys(P19_KERNELS, 0)
    for root in roots:
        d = os.path.join(root, "tmp", "dag_logs")
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name)) as f:
                for line in f:
                    if line.startswith("{"):
                        for k, v in json.loads(line).get(
                                "launches", {}).items():
                            if k in total:
                                total[k] += v
    return total


def p19_states(rep):
    return {r["node"]: r["state"] for r in rep["nodes"]}


def p19_plan(root, device="cuda"):
    from shifu_tpu_torch.pipeline import nodes
    return nodes.pipeline_nodes(
        root, eval_sets=["Eval1", "Eval2"], algorithms=["GBT", "RF"],
        posttrain=True, device=device)


def _steps_records(root):
    """The records of `root`'s tmp/metrics/steps.jsonl (none yet: [])."""
    path = os.path.join(root, "tmp", "metrics", "steps.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def p19_traced_leg_main(root, device):
    """The `--p19-traced-leg` process: (a)'s first DAG run of `p19_plan`
    as a verb runs, inside `profiling.step_metrics` and
    `obs_trace.trace_run` (SHIFU_TPU_TRACE=1 from the parent), so every
    node process joins the trace; prints the report, this process's pid
    and the run id."""
    from shifu_tpu_torch import profiling
    from shifu_tpu_torch.obs import trace as obs_trace
    from shifu_tpu_torch.pipeline.scheduler import run_dag
    with profiling.step_metrics(root, "dag") as rec, \
            obs_trace.trace_run(root, "dag") as run:
        assert run is not None, "SHIFU_TPU_TRACE is not set"
        rep = run_dag(p19_plan(root, device), root=root, label="p19")
        rec["rc"] = 0
    print(json.dumps({"dag": rep, "pid": os.getpid(),
                      "run_id": run.run_id}))


def p19_spawn_traced(args, log, env_extra=None, timeout=900):
    """`python <args>` from the repo's root with SHIFU_TPU_TRACE=1 and no
    inherited trace workspace (a trace run of its own); returns its
    stdout's last line as JSON, or raises with its log's tail."""
    env = dict(os.environ)
    env.pop("SHIFU_TPU_TRACE_DIR", None)
    env.update({"SHIFU_TPU_TRACE": "1"}, **(env_extra or {}))
    with open(log, "w") as err:
        proc = subprocess.run([sys.executable, *args], stdout=subprocess.PIPE,
                              stderr=err, text=True, env=env,
                              timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, \
        f"{' '.join(args)} exited {proc.returncode}:\n" + _log_tail(log)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def p19_trace_gates(root, clone, coord, before, device="cuda"):
    """(a)'s trace gates after the traced leg: one merged trace, named by
    the coordinator's run id, with one `run.step` root of the
    coordinator's pid; a `dag.node` span a node (parent that root, state
    done) with its `dag.queue` and `dag.run` children; one `run.step` of
    each node process in the merge; one steps.jsonl record a node verb
    (rc 0; on the card `backend` cuda and `deviceCount` 1 for all but
    `init`, `peakBytesInUse` > 0 for train.GBT) and the coordinator's
    with a `dag` block of DAG_SUMMARY_FIELDS and a `trace` block."""
    import collections
    import glob
    from shifu_tpu_torch.profiling import DAG_SUMMARY_FIELDS, TRACE_FIELDS
    tdir = os.path.join(root, "tmp", "trace")
    merged = sorted(glob.glob(os.path.join(tdir, "*.trace.json")))
    assert merged == [os.path.join(tdir, coord["run_id"] + ".trace.json")], \
        merged
    with open(merged[0]) as f:
        events = json.load(f)["traceEvents"]
    per_pid = collections.Counter(e["pid"] for e in events
                                  if e["name"] == "run.step")
    roots = [e for e in events if e["name"] == "run.step"
             and e["pid"] == coord["pid"]]
    assert len(roots) == 1, per_pid
    rid = roots[0]["args"]["id"]
    nodes = {e["args"]["node"]: e for e in events if e["name"] == "dag.node"}
    want_nodes = {r["node"] for r in coord["dag"]["nodes"]}
    assert set(nodes) == want_nodes, (sorted(nodes), sorted(want_nodes))
    for name, e in nodes.items():
        assert e["args"]["parent"] == rid and e["args"]["state"] == "done", e
        kids = sorted(k["name"] for k in events
                      if k["name"] in ("dag.queue", "dag.run")
                      and k["args"].get("parent") == e["args"]["id"])
        assert kids == ["dag.queue", "dag.run"], (name, kids)
    children = {p: n for p, n in per_pid.items() if p != coord["pid"]}
    assert len(children) == len(want_nodes) and \
        set(children.values()) == {1}, per_pid
    recs = {d: _steps_records(d)[before.get(d, 0):] for d in (root, clone)}
    coord_rec = [r for r in recs[root] if r["step"] == "dag"]
    node_recs = [(d, r) for d in (root, clone) for r in recs[d]
                 if r["step"] != "dag"]
    assert len(coord_rec) == 1 and coord_rec[0]["rc"] == 0, coord_rec
    assert tuple(coord_rec[0]["dag"]) == DAG_SUMMARY_FIELDS, coord_rec
    assert tuple(coord_rec[0]["trace"]) == TRACE_FIELDS, coord_rec
    verbs = sorted(r["step"] for _, r in node_recs)
    assert verbs == sorted(["init", "stats", "norm", "train", "train", "eval",
                            "eval", "posttrain"]), verbs
    assert all(r["rc"] == 0 for _, r in node_recs), node_recs
    gbt = [r for d, r in node_recs if d == root and r["step"] == "train"]
    if device == "cuda":
        for _, r in node_recs:
            if r["step"] != "init":
                assert r.get("backend") == "cuda" and \
                    r.get("deviceCount") == 1, r
        assert gbt[0]["peakBytesInUse"] > 0, gbt
    trace_block = coord_rec[0]["trace"]
    print(f"  (a) traced: {len(events)} events in one merge, "
          f"{len(children)} node processes with a run.step each, "
          f"dag.node + queue/run for {len(nodes)} nodes; step records "
          f"{verbs} rc 0; coordinator trace {json.dumps(trace_block)}; "
          f"train.GBT peakBytesInUse {gbt[0].get('peakBytesInUse')}")
    return {"events": len(events), "node_processes": len(children),
            "trace": trace_block,
            "gbt_peak_bytes": gbt[0].get("peakBytesInUse")}


def _kernel_intervals(profile_path):
    """(name, start µs, end µs) of every CUDA kernel of a torch.profiler
    Chrome trace, on the span trace's wall clock."""
    with open(profile_path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    return [(e["name"], base + e["ts"], base + e["ts"] + e.get("dur", 0))
            for e in doc["traceEvents"] if e.get("cat") == "kernel"]


def _idle_share(intervals, t0, t1):
    """One minus the union of the intervals within [t0, t1], over it."""
    busy, end = 0.0, t0
    for _, a, b in sorted(intervals, key=lambda k: k[1]):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    return 1.0 - busy / max(t1 - t0, 1e-9)


def p19_profile(root, device="cuda"):
    """(b) `python -m shifu_tpu_torch --profile --dir <copy> train
    --device D` under SHIFU_TPU_TRACE=1 in a fresh process on a copy of
    the pipeline's set: `trace ls` pairs its span trace with its
    profile; the profile's K3 and K5 kernels count what its line
    reports; its record carries `trace` and `tree_build_dispatches`;
    `top` shows its `train` row with rc 0. Prints the step's card idle
    share (one minus the union of kernel intervals over `run.step`)."""
    import shutil
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.obs import trace as obs_trace
    from shifu_tpu_torch.profiling import PROFILE_FILE, TRACE_FIELDS
    t0 = time.monotonic()
    prof = os.path.join(os.path.dirname(root), "p19_profile")
    shutil.copytree(root, prof, ignore=shutil.ignore_patterns(
        "data", "trace", "profile", "metrics", "dag_logs", "dag_models",
        "manifests", "models"))
    line = p19_spawn_traced(
        ["-m", "shifu_tpu_torch", "--profile", "--dir", prof, "train",
         "--device", device], os.path.join(prof, "profile.log"))
    rows = obs_trace.trace_ls(prof)
    assert len(rows) == 1 and rows[0]["trace"] and rows[0]["profile"], rows
    kernels = _kernel_intervals(os.path.join(rows[0]["profile"],
                                             PROFILE_FILE))
    k3 = sum(1 for k in kernels if "level_hist_kernel" in k[0])
    k5 = sum(1 for k in kernels if "best_splits_kernel" in k[0])
    lc = line["launches"]
    assert (k3, k5) == (lc["level_hist"] + lc["level_hist_fused"],
                        lc["best_splits"]), (k3, k5, lc)
    if device == "cuda":
        assert k3 > 0 and k5 > 0, lc
    rec = [r for r in _steps_records(prof) if r["step"] == "train"][-1]
    assert rec["rc"] == 0 and tuple(rec["trace"]) == TRACE_FIELDS, rec
    dispatches = rec["inputPipeline"]["tree_build_dispatches"]
    assert dispatches > 0, rec
    frame = cli._top_render(prof)
    assert any(ln.split()[:2] == ["train", "0"]
               for ln in frame.splitlines()), frame
    with open(rows[0]["trace"]) as f:
        step = [e for e in json.load(f)["traceEvents"]
                if e["name"] == "run.step"]
    assert len(step) == 1, step
    a, b = step[0]["ts"], step[0]["ts"] + step[0]["dur"]
    idle = _idle_share(kernels, a, b)
    out = {"seconds": time.monotonic() - t0, "train_seconds":
           line["seconds"], "step_wall_s": rec["wallSeconds"],
           "kernels": len(kernels), "k3": k3, "k5": k5,
           "tree_build_dispatches": dispatches, "idle_share": idle,
           "launches": {"level_hist": lc["level_hist"],
                        "best_splits": lc["best_splits"]}}
    print(f"  (b) --profile train: {json.dumps(out)}; trace ls pairs "
          f"{rows[0]['run_id']}; top: "
          + [ln for ln in frame.splitlines() if ln.startswith("train")][0])
    return out


def p19_dag_legs(root, device="cuda"):
    """(a)'s two DAG runs of `p19_plan` (GBT + RF, the RF a clone made
    by `prepare_variant`, eval sets Eval1 and Eval2, posttrain) under
    the default admission: the pipeline, traced, as a verb in a process
    of its own (`--p19-traced-leg`), then the RESUME leg with
    eval.Eval1's manifest removed; then (b). Returns both reports, the
    outputs after each, the states the RESUME leg was predicted to end
    in, the child processes' launches, the trace gates' and (b)'s
    results."""
    import shutil
    from shifu_tpu_torch.pipeline import nodes
    from shifu_tpu_torch.pipeline.scheduler import run_dag
    clone = nodes.variant_dir(root, "train.RF")
    before = {d: len(_steps_records(d)) for d in (root, clone)}
    t0 = time.monotonic()
    coord = p19_spawn_traced(
        [os.path.abspath(__file__), "--p19-traced-leg", root, device],
        os.path.join(os.path.dirname(root), "p19_traced_leg.log"))
    out = {"dag": coord["dag"], "traced_leg_s": time.monotonic() - t0}
    out["outputs"] = p19_outputs(root, clone)
    out["launches"] = p19_log_launches(root, clone)
    out["trace"] = p19_trace_gates(root, clone, coord, before, device)
    # RESUME: a node parks as cached when its manifest still matches its
    # inputs; posttrain rewrote ColumnConfig.json, an input of every
    # manifest's fingerprint, after stats, norm, train and the evals
    # that finished before it wrote theirs (C-ref-4), so those run again
    os.remove(os.path.join(root, "tmp", "manifests", "eval.Eval1.json"))
    for d in (root, clone):
        shutil.rmtree(os.path.join(d, "tmp", "dag_logs"))
    with _environ({"SHIFU_TPU_RESUME": "1"}):
        plan = p19_plan(root, device)
        out["predicted"] = {n.name: "cached" if n.done_check() else "done"
                            for n in plan}
        out["resume"] = run_dag(plan, root=root, label="p19-resume")
    out["after"] = p19_outputs(root, clone)
    out["resume_launches"] = p19_log_launches(root, clone)
    out["profile"] = p19_profile(root, device)
    return out


def p19_walk(seq, device="cuda"):
    """The steps of `p19_plan` walked one after another in this process
    (`cli.main`) on `seq`, a copy of the set; returns their lines."""
    from shifu_tpu_torch.pipeline import nodes
    clone = nodes.variant_dir(seq, "train.RF")
    lines = run_verbs([(seq, ["init"]), (seq, ["stats"]), (seq, ["norm"]),
                       (seq, ["train"])], device)
    nodes.prepare_variant(seq, clone, algorithm="RF")
    lines += run_verbs([(clone, ["train"]),
                        (seq, ["eval", "-run", "Eval1"]),
                        (seq, ["eval", "-run", "Eval2"]),
                        (seq, ["posttrain"])], device)
    assert all(ln["rc"] == 0 for ln in lines), lines
    return lines


def p19_pipeline_gates(legs, root, seq, wall):
    """(a)'s gates: every node done; train.GBT and train.RF overlap
    (timeshared: max_concurrent >= 2; sliced: each on a lease of its
    own); the outputs equal the sequential walk's to the bit; the RESUME
    leg ends in the predicted states, eval.Eval1 among those that run,
    the others that run among those C-ref-4 stales (P19_STALE), the
    rest (init, train.RF, posttrain) cached, and every output as it
    was."""
    from shifu_tpu_torch.pipeline import nodes
    rep = legs["dag"]
    states = p19_states(rep)
    assert set(states.values()) == {"done"}, states
    if rep["total_devices"] is None:
        assert rep["max_concurrent"] >= 2, rep
        overlap = f"timeshared, max_concurrent {rep['max_concurrent']}"
    else:
        by = {r["node"]: r["devices"] for r in rep["nodes"]}
        assert by["train.GBT"] and by["train.RF"] and \
            by["train.GBT"] + by["train.RF"] <= rep["total_devices"], by
        overlap = f"sliced over {rep['total_devices']} cards, leases " \
            f"{by['train.GBT']} + {by['train.RF']}"
    got = legs["outputs"]
    want = p19_outputs(seq, nodes.variant_dir(seq, "train.RF"))
    differ = sorted(k for k in want if got.get(k) != want[k])
    assert not differ, f"DAG outputs differ from the sequential walk: " \
        f"{differ}"
    predicted = legs["predicted"]
    assert predicted["eval.Eval1"] == "done", predicted
    assert all(v == "cached" for k, v in predicted.items()
               if k not in P19_STALE), predicted
    assert p19_states(legs["resume"]) == predicted, \
        (p19_states(legs["resume"]), predicted)
    after = legs["after"]
    assert after == got, sorted(k for k in got if after.get(k) != got[k])
    ran = sorted(k for k, v in predicted.items() if v == "done")
    print(f"  (a) DAG {overlap}: wall {rep['wall_s']} s, critical path "
          f"{rep['critical_path_s']} s, occupancy {rep['occupancy']}; "
          f"outputs = the sequential walk's ({len(want)} files); RESUME "
          f"{legs['resume']['wall_s']} s ran {ran}, outputs unchanged, "
          f"launches {legs['resume_launches']}")
    launches = {k: legs["launches"][k] + legs["resume_launches"][k]
                + legs["profile"]["launches"].get(k, 0)
                for k in P19_KERNELS}
    return {"dag": rep, "wall_s": wall, "resume": legs["resume"],
            "resume_ran": ran, "launches": launches,
            "traced_leg_s": legs["traced_leg_s"], "trace": legs["trace"],
            "profile": legs["profile"]}


def p19_segments(workdir, eval_dir, device="cuda"):
    """(b) The segment siblings in this process: `stats -base-only`,
    `-seg 1`, `-seg 2` and `-seg-merge` on the card against an inline
    `stats` on the card and its `--device cpu` twin, byte for byte."""
    from shifu_tpu_torch.fileio import atomic_write
    roots = {}
    for name in ("sib", "card", "cpu"):
        root = p19_set(os.path.join(workdir, f"p19_seg_{name}"), eval_dir,
                       seed=192)
        seg = os.path.join(root, "columns", "segments.txt")
        with atomic_write(seg) as f:
            f.write("\n".join(P19_SEGMENTS) + "\n")
        set_config(root, "dataSet", segExpressionFile=seg)
        roots[name] = root
    t0 = time.monotonic()
    lines = run_verbs([(roots["sib"], ["init"])]
                      + [(roots["sib"], ["stats", *f]) for f in (
                          ["-base-only"], ["-seg", "1"], ["-seg", "2"],
                          ["-seg-merge"])], device)
    sib_s = time.monotonic() - t0
    lines += run_verbs([(roots["card"], ["init"]),
                        (roots["card"], ["stats"])], device)
    lines += run_verbs([(roots["cpu"], ["init"]),
                        (roots["cpu"], ["stats"])], "cpu")
    assert all(ln["rc"] == 0 for ln in lines), lines
    ccs = {}
    for name, root in roots.items():
        with open(os.path.join(root, "ColumnConfig.json"), "rb") as f:
            ccs[name] = f.read()
    assert ccs["sib"] == ccs["card"], \
        "the segment siblings' ColumnConfig.json differs from inline stats"
    assert ccs["sib"] == ccs["cpu"], \
        "the segment siblings' ColumnConfig.json differs from the CPU twin"
    n_seg = sum(1 for c in json.loads(ccs["sib"]) if c.get("segment"))
    assert n_seg == 2 * 33, n_seg
    print(f"  (b) segment siblings in {sib_s:.1f} s: ColumnConfig.json "
          f"= inline card stats = the CPU twin's, to the byte")
    return {"sibling_s": sib_s,
            "steps": [{k: ln.get(k) for k in ("step", "device", "rows",
                                              "seconds")} for ln in lines]}


def p19_combo(workdir, eval_dir, device="cuda"):
    """(c) `combo -new NN,GBT,LR`, `-init`, `-run`, `-run -resume` and
    `-eval` on the card (the sub-models as processes), the assemble's
    AUC against `combo.evaluate` on the CPU over the same files."""
    from shifu_tpu_torch.processor import combo
    from shifu_tpu_torch.processor.base import ProcessorContext
    root = p19_set(os.path.join(workdir, "p19_combo"), eval_dir, seed=193)
    set_config(root, "dataSet", weightColumnName="")
    lines = run_verbs([(root, ["combo", "-new", "NN,GBT,LR"]),
                       (root, ["combo", "-init"])], device)
    with open(os.path.join(root, "ComboTrain.json")) as f:
        spec = json.load(f)
    asm = os.path.join(root, spec["assemble"]["name"], "models",
                       "model0.lr")
    runs = []
    for extra in ([], ["-resume"]):
        runs += run_verbs([(root, ["combo", "-run", *extra, "--device",
                                   device])], device)
        with open(asm, "rb") as f:
            runs[-1]["model"] = f.read()
    assert all(ln["rc"] == 0 for ln in lines + runs), lines + runs
    subs = [f"combo.{s['name']}" for s in spec["subModels"]]
    first, second = (p19_states(ln["dag"]) for ln in runs)
    assert all(first[s] == "done" for s in subs), first
    assert runs[0]["dag"]["max_concurrent"] >= 2, runs[0]["dag"]
    assert all(second[s] == "cached" for s in subs), second
    assert runs[1]["model"] == runs[0]["model"], \
        "-resume rewrote another assemble model"
    ev = run_verbs([(root, ["combo", "-eval", "--device", device])],
                   device)[0]
    assert ev["rc"] == 0, ev
    ctx = ProcessorContext.load(root)
    ec = ctx.model_config.evals[0]
    table, tags, weights = combo.eval_table(ctx.model_config, ec)
    # the scores held against the CPU's: launches to compare, not counted
    before = p19_counts()
    card = combo.assemble_scores(ctx, table, device)
    compare = {k: v - before[k] for k, v in p19_counts().items()}
    cpu = combo.assemble_scores(ctx, table, "cpu")
    report = {}
    assert combo.evaluate(ctx, ec.name, device="cpu", report=report) == 0
    # the scores first, within phase 15's score gate (phase 11's 1e-5,
    # K1's 3xTF32): the allowance below grows with their difference
    delta = float(np.max(np.abs(card - cpu)))
    assert delta <= P19_SCORE_TOL, \
        f"combo's card scores differ from the CPU's by {delta}"
    allow, _ = auc_allowance(cpu, tags, weights, delta + 1e-6, 0.0)
    auc_err = abs(ev["auc"][ec.name] - report["auc"][ec.name])
    assert auc_err <= 1e-6 + allow, (ev["auc"], report["auc"], allow)
    in_process = {k: sum(ln["launches"][k] for ln in runs + [ev])
                  for k in P19_KERNELS}
    print(f"  (c) combo: -run {runs[0]['seconds']:.1f} s (sub-models "
          f"overlap, max_concurrent {runs[0]['dag']['max_concurrent']}), "
          f"-resume {runs[1]['seconds']:.1f} s (subs cached, the same "
          f"assemble), -eval AUC {ev['auc'][ec.name]} vs CPU "
          f"{report['auc'][ec.name]} (|d| {auc_err:.3g} <= 1e-6 + "
          f"{allow:.3g}; scores |d| {delta:.3g} <= {P19_SCORE_TOL})")
    return {"run_s": runs[0]["seconds"], "resume_s": runs[1]["seconds"],
            "eval_s": ev["seconds"], "dag": runs[0]["dag"],
            "auc": ev["auc"][ec.name], "auc_cpu": report["auc"][ec.name],
            "auc_err": auc_err, "auc_allowance": allow,
            "score_err": delta, "in_process": in_process,
            "compare": compare, "launches": p19_log_launches(root)}


def p19_test(root):
    """(d) `test -n 200` in this process: rc 0 and the JAX package's
    five host nodes, each done."""
    line = run_verbs([(root, ["test", "-n", "200"])], "host")[0]
    assert line["rc"] == 0, line
    got = {r["node"]: (r["deps"], r["state"]) for r in line["dag"]["nodes"]}
    assert got == {k: (v, "done") for k, v in P19_DEPS.items()}, got
    print(f"  (d) test -n 200: {list(got)} done in {line['seconds']:.2f} s")
    return {"seconds": line["seconds"], "dag": line["dag"]}


def p19_counts():
    from shifu_tpu_torch.ops import best_splits, fused_score, fused_trees
    from shifu_tpu_torch.ops import level_hist
    return {"fused_score": fused_score.launches,
            "fused_trees": fused_trees.launches,
            "level_hist": level_hist.launches,
            "best_splits": best_splits.launches}


def p19_main(workdir, device):
    """The `--p19-dag` process: (a)'s DAG legs (child processes) on one
    thread while this process walks (a)'s steps and runs (b), (c) and
    (d) on another; then (a)'s gates. The last line holds the result,
    with the kernels' launches of this process (less (c)'s comparison)
    and of the DAG's child processes (their step lines)."""
    import shutil
    from shifu_tpu_torch.ops import best_splits, fused_score, fused_trees
    from shifu_tpu_torch.ops import level_hist
    fused_score.launches = fused_trees.launches = 0
    level_hist.launches = best_splits.launches = 0
    t0 = time.monotonic()
    eval_dir = os.path.join(workdir, "p19_eval")
    root = p19_set(os.path.join(workdir, "p19_dag"), eval_dir)
    seq = shutil.copytree(root, os.path.join(workdir, "p19_seq"),
                          ignore=shutil.ignore_patterns("data"))
    out = {}

    def in_process():
        p19_walk(seq, device)
        out["b"] = p19_segments(workdir, eval_dir, device)
        out["c"] = p19_combo(workdir, eval_dir, device)
        out["d"] = p19_test(os.path.join(workdir, "p19_seg_card"))
    legs, _ = in_parallel(lambda: p19_dag_legs(root, device), in_process)
    out["a"] = p19_pipeline_gates(legs, root, seq, time.monotonic() - t0)
    here = p19_counts()
    out["launches"] = {k: here[k] - out["c"]["compare"][k]
                       + out["a"]["launches"][k] + out["c"]["launches"][k]
                       for k in P19_KERNELS}
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out, default=str))


def background_start(workdir, flag, device="cuda"):
    """`chip_smoke.py <flag> <workdir> <device>` (phase 10's `--p10`,
    phase 14's `--p14-launches`, phase 19's `--p19-dag`) in a process
    of its own, to run beside the phases that follow: returns (process,
    its log's path)."""
    os.makedirs(workdir, exist_ok=True)
    log = os.path.join(workdir, flag.strip("-") + ".log")
    return p18_spawn([os.path.abspath(__file__), flag, workdir, device],
                     log), log


def background_finish(started, flag):
    """Wait for a `background_start` process: it must exit 0; print the
    lines it printed and return its last line's JSON object."""
    proc, log = started
    try:
        res, _ = proc.communicate(timeout=900)
    finally:
        background_stop(started)
    assert proc.returncode == 0, f"{flag} failed:\n" + _log_tail(log)
    lines = res.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    return json.loads(lines[-1])


def background_stop(started):
    proc = started[0]
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def phase_dag_finish(report, started, device="cuda"):
    """Collect phase 19: every gate held in its process; its K2, K3 and
    K5 launches (and K1's, none) join the kernels line."""
    out = background_finish(started, "--p19-dag")
    for k in P19_KERNELS:
        if device == "cuda" and k in P19_PATH:
            assert out["launches"][k] > 0, \
                f"phase 19 launched no {k}: {out['launches']}"
        report[k]["launches"] += out["launches"][k]
    report["p19"] = out
    print(f"  phase 19: {out['seconds']:.1f} s in its process (the traced "
          f"leg {out['a']['traced_leg_s']:.1f} s, (b) "
          f"{out['a']['profile']['seconds']:.1f} s), launches "
          f"{json.dumps(out['launches'])}")


# ---------------------------------------------------------------------------
# Phase 20: parquet and scheme:// model sets, and the tf kind
# ---------------------------------------------------------------------------

P20_ROWS = TRAIN_ROWS          # phase 8's raw table
P20_EVAL_ROWS = 65_536         # its holdout, eval set Eval1
P20_PARTS = 4                  # the parquet set's part files
P20_GBT = {"TreeNum": 10, "MaxDepth": TRAIN_DEPTH,    # phase 8's gbt_log
           "LearningRate": TRAIN_LR, "Loss": "log"}
P20_STEPS = (["init"], ["stats"], ["norm"], ["train"], ["eval"])
# every output held byte for byte between the routes
P20_OUTPUTS = ("ColumnConfig.json", "tmp/CleanedData/data.npz",
               "tmp/CleanedData/meta.json", "tmp/NormalizedData/data.npz",
               "tmp/NormalizedData/meta.json", "models/model0.gbt",
               "evals/Eval1/EvalScore.csv",
               "evals/Eval1/EvalPerformance.json")
P20_PATH = ("fused_trees", "level_hist", "best_splits")
P20_NN_ROWS = 4_096            # (c)'s 600-column table
P20_TF_TOL = 1e-5              # K1's 3xTF32 gate of phase 2
P20_SEG_ROWS = 1_024           # (b)'s row log segment


def p20_set(root, data_path, header_path, eval_path, eval_header):
    """Phase 8's GBT set (log loss, 10 trees) over the given dataPath
    and eval set Eval1, its paths as given (local, `file://` or
    `memory://`; an empty headerPath reads the header from the data)."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    os.makedirs(root, exist_ok=True)
    ds = {"dataPath": data_path, "dataDelimiter": "|",
          "headerPath": header_path, "targetColumnName": "label",
          "posTags": ["1"], "negTags": ["0"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeP20"}, "dataSet": ds,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE"},
        "train": {"algorithm": "GBT", "validSetRate": 0.1,
                  "params": P20_GBT},
        "evals": [{"name": "Eval1", "dataSet": dict(
            ds, dataPath=eval_path, headerPath=eval_header)}]}).save(root)


def p20_parquet(url_dir, names, x, y, parts):
    """The table as `parts` parquet part files under `url_dir`, every
    column float32 (a missing value null), written through the port's
    `data/parquet.write_part`."""
    from shifu_tpu_torch.data import parquet
    from shifu_tpu_torch.data.reader import Table
    cols = {n: x[:, j] for j, n in enumerate(names[:-1])}
    cols[names[-1]] = y.astype(np.float32)
    table = Table(cols)
    edges = np.linspace(0, len(y), parts + 1).astype(int)
    for k in range(parts):
        parquet.write_part(f"{url_dir}/part-{k:05d}.parquet",
                           table.select(np.arange(edges[k], edges[k + 1])))


def p20_upload(local_dir, url_dir):
    """A local part file and its `.pig_header` copied to `url_dir`."""
    import fsspec
    for name in ("part-00000", ".pig_header"):
        with open(os.path.join(local_dir, name), "rb") as f:
            data = f.read()
        with fsspec.open(f"{url_dir}/{name}", "wb") as f:
            f.write(data)


def p20_same(a_root, b_root, what):
    for rel in P20_OUTPUTS:
        same_bytes(os.path.join(a_root, rel), os.path.join(b_root, rel),
                   f"phase 20 {what}, {rel}")


def p20_run(root, device):
    """`init → stats → norm → train → eval` through `cli.main` in this
    process; returns the step lines, printed, and the launches of the
    path's kernels the train and eval lines report."""
    lines = run_verbs([(root, a) for a in P20_STEPS], device)
    for args, line in zip(P20_STEPS, lines):
        assert line["rc"] == 0, (root, args, line)
        line.pop("printed")
    train, ev = lines[3], lines[4]
    launches = {"fused_trees": ev["launches"]["fused_trees"],
                "level_hist": train["launches"]["level_hist"],
                "best_splits": train["launches"]["best_splits"]}
    return lines, launches


def p20_parquet_and_remote(workdir, device="cuda", rows=P20_ROWS,
                           eval_rows=P20_EVAL_ROWS):
    """(a) phase 8's raw table as delimited text (a local part file) and
    as `P20_PARTS` float32 parquet parts under a `file://` URL, its
    holdout the same way: `init → stats → norm → train → eval` on the
    card over both, every output byte-equal; (b) the same text behind
    `memory://` (dataPath, headerPath and the eval set), equal to (a)'s
    text route to the bit; then a row log on a `file://` root seals one
    segment and an abort scope there reads and clears its marker."""
    import fsspec
    from shifu_tpu_torch import resilience
    from shifu_tpu_torch.data import ingest
    rng = np.random.default_rng(200)
    names, cols, x, y = raw_table(rng, rows, False)
    e_names, e_cols, ex, ey = raw_table(np.random.default_rng(201),
                                        eval_rows, False)
    out = {}
    t0 = time.monotonic()
    text = os.path.join(workdir, "p20_text")
    write_raw(os.path.join(text, "data"), names, cols)
    write_raw(os.path.join(text, "evaldata"), e_names, e_cols)
    p20_set(text, os.path.join(text, "data"),
            os.path.join(text, "data", ".pig_header"),
            os.path.join(text, "evaldata"),
            os.path.join(text, "evaldata", ".pig_header"))
    pq_url = "file://" + os.path.join(workdir, "p20_pq_data")
    p20_parquet(pq_url + "/data", names, x, y, P20_PARTS)
    p20_parquet(pq_url + "/evaldata", e_names, ex, ey, 1)
    pq_root = os.path.join(workdir, "p20_parquet")
    p20_set(pq_root, pq_url + "/data", "", pq_url + "/evaldata", "")
    mem_url = f"memory://p20_{os.getpid()}"
    p20_upload(os.path.join(text, "data"), mem_url + "/data")
    p20_upload(os.path.join(text, "evaldata"), mem_url + "/evaldata")
    mem_root = os.path.join(workdir, "p20_memory")
    p20_set(mem_root, mem_url + "/data", mem_url + "/data/.pig_header",
            mem_url + "/evaldata", mem_url + "/evaldata/.pig_header")
    out["write_s"] = time.monotonic() - t0
    launches = {k: 0 for k in P20_PATH}
    for name, root in (("text", text), ("parquet", pq_root),
                       ("memory", mem_root)):
        t1 = time.monotonic()
        lines, got = p20_run(root, device)
        out[name] = {"seconds": time.monotonic() - t1, "lines": lines,
                     "launches": got}
        print(f"  (a/b) {name}: {out[name]['seconds']:.1f} s, launches "
              f"{json.dumps(got)}")
        for step in lines:
            print(f"    {json.dumps(step)}")
        if device == "cuda":
            assert all(v > 0 for v in got.values()), (name, got)
        for k in P20_PATH:
            launches[k] += got[k]
    p20_same(pq_root, text, "(a) parquet vs text")
    print("  (a) parquet (file://, 4 float32 parts) = delimited text: "
          + ", ".join(P20_OUTPUTS) + " byte-equal")
    p20_same(mem_root, text, "(b) memory:// vs text")
    print("  (b) memory:// = (a)'s text route, byte for byte")
    fsspec.filesystem("memory").rm(mem_url[len("memory://"):],
                                   recursive=True)

    # a row log and an abort scope on a file:// root
    log_root = "file://" + os.path.join(workdir, "p20_log")
    log = ingest.RowLog(log_root, header=names, segment_rows=P20_SEG_ROWS,
                        segment_age_s=1e9)
    batch = ["|".join(r) for r in np.stack(cols, 1)[:P20_SEG_ROWS]
             .tolist()]
    log.append(batch)
    inv = log.inventory()
    assert inv["sealed_rows"] == P20_SEG_ROWS and \
        inv["partitions"][0]["sealed_segments"] == 1, inv
    win = log.read_window("watch")
    assert win.lines == batch
    log.commit("watch", win.end)
    assert ingest.RowLog(log_root).lag("watch") == 0
    scope = "file://" + os.path.join(workdir, "p20_scope", "tmp")
    resilience.set_abort_scope(scope)
    try:
        resilience.publish_abort("dag.p20", RuntimeError("planted"))
        rec = resilience.check_abort()
        assert rec["site"] == "dag.p20" and "planted" in rec["error"], rec
        resilience.clear_abort()
        assert resilience.check_abort() is None
    finally:
        resilience.set_abort_scope(None)
    print(f"  (b) row log on {log_root}: one sealed segment of "
          f"{P20_SEG_ROWS} rows read back and committed; abort marker on "
          "a file:// scope read and cleared")
    out["launches"] = launches
    return out


def p20_tf_main(workdir, device):
    """(c), the `--p20-tf` process: TensorFlow never shares a process
    with another phase. Phase 11's wide NN (600 → 512 → 256 → 1, weights
    from a seed) over a ZSCALE set of `P20_NN_ROWS` rows, `init` and
    `stats` on the card; with tensorflow, `export -t tf` of it and
    `eval` of the NN spec beside its SavedModel: the NN column through
    K1, the SavedModel's on the host, within `P20_TF_TOL`. Without
    tensorflow, `eval` of the NN through K1, and `export -t tf` and the
    scoring of a SavedModel raise the gating errors. Last line: the
    result, with K1's launches."""
    from shifu_tpu_torch.config.model_config import ModelConfig
    from shifu_tpu_torch.eval import scorer
    from shifu_tpu_torch.models.spec import save_model
    t0 = time.monotonic()
    names, tokens = nn_raw_table(np.random.default_rng(203), P20_NN_ROWS)
    root = os.path.join(workdir, "p20_nn")
    data_dir = os.path.join(root, "data")
    write_raw(data_dir, names, tokens)
    ds = {"dataPath": data_dir, "dataDelimiter": "|",
          "headerPath": os.path.join(data_dir, ".pig_header"),
          "targetColumnName": "label", "posTags": ["1"], "negTags": ["0"]}
    ModelConfig.from_dict({
        "basic": {"name": "smokeP20NN"}, "dataSet": ds,
        "stats": {"maxNumBin": GBT_BINS - 1,
                  "binningMethod": "EqualPositive"},
        "normalize": {"normType": "ZSCALE", "stdDevCutOff": CUTOFF},
        "train": {"algorithm": "NN"},
        "evals": [{"name": "Eval1", "dataSet": ds}]}).save(root)
    save_model(os.path.join(root, "models", "model0.nn"), "nn",
               {"spec": {"input_dim": NN_IN, "hidden_dims": list(NN_HIDDEN),
                         "activations": ["relu", "relu"]}},
               nn_params(np.random.default_rng(204)))
    for line in run_verbs([(root, ["init"]), (root, ["stats"])], device):
        assert line["rc"] == 0, line
    out = {"tensorflow": True}
    try:
        export = run_verbs([(root, ["export", "-t", "tf"])], device)[0]
        assert export["rc"] == 0, export
    except NotImplementedError as e:
        out["tensorflow"] = False
        assert "needs the optional tensorflow package" in str(e), e
        out["export_error"] = str(e)
    path = os.path.join(root, "ModelConfig.json")
    with open(path) as f:
        d = json.load(f)
    d["evals"] = [{"name": "Eval1", "dataSet": ds, "customPaths": (
        {"genericModelsPath": "tfmodel"} if out["tensorflow"] else {})}]
    ModelConfig.from_dict(d).save(root)
    ev = run_verbs([(root, ["eval"])], device)[0]
    assert ev["rc"] == 0, ev
    ev.pop("printed")
    out["eval"] = ev
    out["launches"] = {"fused_score": ev["launches"]["fused_score"]}
    if device == "cuda":
        assert out["launches"]["fused_score"] > 0, ev
    with open(os.path.join(root, "evals", "Eval1", "EvalScore.csv")) as f:
        header = f.readline().strip().split(",")
        body = np.loadtxt(f, delimiter=",", ndmin=2)
    assert body.shape[0] == P20_NN_ROWS, body.shape
    if out["tensorflow"]:
        a = body[:, header.index("model0")]
        b = body[:, header.index("model1")]
        out["max_abs_err"] = float(np.abs(a - b).max())
        assert out["max_abs_err"] <= P20_TF_TOL, out["max_abs_err"]
    else:
        # the scoring side's gate: a SavedModel directory loads as the
        # `tf` kind, and scoring it raises before reading it
        fake = os.path.join(workdir, "p20_fake_savedmodel")
        os.makedirs(fake)
        open(os.path.join(fake, "saved_model.pb"), "wb").close()
        try:
            scorer.score_matrix("tf", {"path": fake}, fake,
                                np.zeros((2, NN_IN), np.float32))
            raise AssertionError("scoring a SavedModel without tensorflow "
                                 "did not raise")
        except NotImplementedError as e:
            assert "needs the optional tensorflow package" in str(e), e
            out["score_error"] = str(e)
    out["seconds"] = time.monotonic() - t0
    print(json.dumps(out, default=str))


def p20_main(workdir, device):
    """The `--p20` process: (c) started in a process of its own, (a) and
    (b) here, then (c) collected. Last line: the result, with the
    kernels' launches of (a), (b) and (c)."""
    from shifu_tpu_torch.ops import best_splits, fused_score, fused_trees
    from shifu_tpu_torch.ops import level_hist
    fused_score.launches = fused_trees.launches = 0
    level_hist.launches = best_splits.launches = 0
    t0 = time.monotonic()
    tf_started = background_start(os.path.join(workdir, "p20_tf"),
                                  "--p20-tf", device)
    try:
        out = p20_parquet_and_remote(workdir, device)
        out["c"] = background_finish(tf_started, "--p20-tf")
    finally:
        background_stop(tf_started)
    c = out["c"]
    if c["tensorflow"]:
        print(f"  (c) tensorflow: export -t tf of the wide NN and eval "
              f"beside it: the SavedModel's scores within "
              f"{c['max_abs_err']:.3g} of K1's (gate {P20_TF_TOL})")
    else:
        print("  (c) tensorflow is absent: the wide NN's eval through K1, "
              "and the gating errors of `export -t tf` and of scoring a "
              "SavedModel checked")
    out["launches"]["fused_score"] = c["launches"]["fused_score"]
    out["seconds"] = time.monotonic() - t0
    for k in ("text", "parquet", "memory"):
        out[k].pop("lines")
    print(json.dumps(out, default=str))


def phase_remote_parquet_finish(report, started, device="cuda"):
    """Collect phase 20: every gate held in its process; its K1, K2, K3
    and K5 launches join the kernels line."""
    out = background_finish(started, "--p20")
    for k, v in out["launches"].items():
        if device == "cuda":
            assert v > 0, f"phase 20 launched no {k}: {out['launches']}"
        report[k]["launches"] += v
    report["p20"] = out
    print(f"  phase 20: {out['seconds']:.1f} s in its process (writes "
          f"{out['write_s']:.1f} s; text {out['text']['seconds']:.1f} s, "
          f"parquet {out['parquet']['seconds']:.1f} s, memory:// "
          f"{out['memory']['seconds']:.1f} s; (c) "
          f"{out['c']['seconds']:.1f} s), launches "
          f"{json.dumps(out['launches'])}")


SOURCES = {
    "fused_score": ("shifu_tpu_torch/csrc/fused_score.cu",
                    "shifu_tpu/ops/pallas_score.py:110"),
    "fused_trees": ("shifu_tpu_torch/csrc/fused_trees.cu",
                    "shifu_tpu/ops/pallas_trees.py:203"),
    "level_hist": ("shifu_tpu_torch/csrc/level_hist.cu",
                   "shifu_tpu/ops/pallas_hist.py:250"),
    "level_hist_fused": ("shifu_tpu_torch/csrc/level_hist.cu",
                         "shifu_tpu/ops/pallas_hist.py:338"),
    "best_splits": ("shifu_tpu_torch/csrc/best_splits.cu",
                    "shifu_tpu/ops/pallas_split.py:144"),
}


def main_phases_15_19(report, header):
    """Phases 15-18 of the main run, phase 19 in a process of its own
    beside them."""
    with tempfile.TemporaryDirectory() as p19dir:
        dag = background_start(p19dir, "--p19-dag")
        try:
            header("phase 15: past the trigger (the streaming steps) on the "
                   "card vs the CPU twin")
            with tempfile.TemporaryDirectory() as workdir:
                phase_past_trigger(report, workdir)
            header("phase 16: serving graphs, swap, registry/fleet and the "
                   "health plane on the card")
            with tempfile.TemporaryDirectory() as workdir:
                dirs = phase_serving_plane(report, workdir)
                header("phase 17: the closed loop (row log, refresh, "
                       "canary, full watch) on the card")
                phase_closed_loop(report, workdir, dirs)
                header("phase 18: checkpoints and resume (kill, preempt, "
                       "the streaming NN, the step manifests) on the card")
                phase_checkpoint_resume(report, workdir)
            header("phase 19: the pipeline DAG, the segment siblings, "
                   "combo and test on the card (started with phase 15)")
            phase_dag_finish(report, dag)
        finally:
            background_stop(dag)


_IMPORT_PROBE = r"""
import importlib
import json
import sys
out = {}
for name in sys.argv[1:]:
    try:
        out[name] = getattr(importlib.import_module(name), "__version__", "?")
    except Exception as e:  # reported, not raised
        out[name] = None
        out[name + "_error"] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
"""


def import_probe_start(names=("pyarrow", "tensorflow")):
    """Whether the optional packages import on this machine, asked in a
    child process (so that neither loads into this one)."""
    return _spawn(["-c", _IMPORT_PROBE, *names])


def import_probe_finish(proc, names=("pyarrow", "tensorflow")):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    for name in names:
        v = res[name]
        print(f"{name}: import {name} "
              + (f"succeeds ({v})" if v else
                 f"fails ({res[name + '_error']})"))
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cpu-verbs"]:
        # phase 13's CPU twin: its steps' lines, no result line
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        with open(sys.argv[2]) as f:
            steps = json.load(f)
        print(json.dumps(run_verbs(steps, "cpu")))
        return 0
    if sys.argv[1:2] == ["--p17-gbt"]:
        # phase 17 (b) in a process of its own: its retrain's marker
        # kernels, traced in a fresh process
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p17_gbt_main(*sys.argv[2:5])
        return 0
    if sys.argv[1:2] == ["--p18-gbt"]:
        # phase 18 (d) in a process of its own, for the same reason
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p18_gbt_main(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--p10"]:
        # phase 10 in a process of its own, beside phases 11-13: its
        # lines, then its result
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        out = {}
        phase_pipeline(out, sys.argv[2], sys.argv[3])
        print(json.dumps(out["pipeline"]))
        return 0
    if sys.argv[1:2] == ["--p14-launches"]:
        # phase 14's launch gate in a process of its own, beside the
        # rest of phase 14 (a workdir and a device may follow, unused)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps({"p14_launches": p14_launches()}))
        return 0
    if sys.argv[1:2] == ["--p19-dag"]:
        # phase 19 in a process of its own, beside phases 15-18
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p19_main(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--p20"]:
        # phase 20 in a process of its own, beside phases 15-19
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p20_main(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--p20-tf"]:
        # phase 20 (c): TensorFlow in a process of its own
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p20_tf_main(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--p19-traced-leg"]:
        # phase 19 (a)'s traced DAG leg, the coordinator of its trace
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        p19_traced_leg_main(*sys.argv[2:4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import shifu_tpu_torch  # noqa: F401  (sets TF32 off)

    t_start = time.monotonic()
    name, smi = phase_device()
    if sys.argv[1:] == ["--train-walls"]:
        walls, split_ms = train_walls()
        print(json.dumps({"train_walls_s": walls,
                          "split_host_ms_per_level": split_ms}))
        return 0
    if sys.argv[1:2] == ["--serve-walls"]:
        sizes = tuple(int(n) for n in sys.argv[2].split(",")) \
            if len(sys.argv) > 2 else (1, 8, 64, 512)
        print(json.dumps({"serve_walls_ms": serve_walls(sizes)}))
        return 0
    if sys.argv[1:2] == ["--serve-walls-pairs"]:
        print(json.dumps({"serve_wall_pairs": serve_wall_pairs(
            sys.argv[2], int(sys.argv[3]))}))
        return 0
    if sys.argv[1:] == ["--k5-timing"]:
        print(json.dumps({"k5_timing": k5_timing()}))
        return 0
    if sys.argv[1:] == ["--pipeline-walls"]:
        print(json.dumps({"pipeline_walls": pipeline_walls()}))
        return 0
    if sys.argv[1:] == ["--eval-walls"]:
        print(json.dumps({"eval_walls": eval_walls()}))
        return 0
    if sys.argv[1:] == ["--nn-train-walls"]:
        print(json.dumps({"nn_train_walls": nn_train_walls()}))
        return 0
    if sys.argv[1:] == ["--p14-walls"]:
        print(json.dumps({"p14_walls": p14_walls()}))
        return 0
    if sys.argv[1:] == ["--varselect-walls"]:
        print(json.dumps({"varselect_walls": varselect_walls()}))
        return 0
    if sys.argv[1:] == ["--k3-timing"]:
        print(json.dumps({"k3_timing": k3_timing()}))
        return 0
    if sys.argv[1:] == ["--stream-walls"]:
        print(json.dumps({"stream_walls": trigger_walls()}))
        return 0
    if sys.argv[1:] == ["--closed-loop"]:
        phase_build()
        report = {k: {"launches": 0} for k in SOURCES}
        with tempfile.TemporaryDirectory() as workdir:
            # phase 16's artifacts that phase 17 reuses
            dirs, _ = p16_swap_sets(workdir)
            p16_health({}, workdir)
            phase_closed_loop(report, workdir, dirs)
        print(json.dumps({k: report[k]["launches"] for k in SOURCES}))
        return 0
    if sys.argv[1:] == ["--checkpoint-resume"]:
        phase_build()
        report = {k: {"launches": 0} for k in SOURCES}
        with tempfile.TemporaryDirectory() as workdir:
            p16_health({}, workdir)       # phase 16 (d)'s GBT set
            phase_checkpoint_resume(report, workdir)
        print(json.dumps({k: report[k]["launches"] for k in SOURCES}))
        return 0
    if sys.argv[1:] == ["--dag"]:
        phase_build()
        report = {k: {"launches": 0} for k in SOURCES}
        with tempfile.TemporaryDirectory() as workdir:
            phase_dag_finish(report, background_start(workdir, "--p19-dag"))
        print(json.dumps({k: report[k]["launches"] for k in SOURCES}))
        return 0
    if sys.argv[1:] == ["--remote-parquet"]:
        phase_build()
        report = {k: {"launches": 0} for k in SOURCES}
        with tempfile.TemporaryDirectory() as workdir:
            phase_remote_parquet_finish(
                report, background_start(workdir, "--p20"))
        print(json.dumps({k: report[k]["launches"] for k in SOURCES}))
        return 0
    if sys.argv[1:] == ["--serving-plane"]:
        phase_build()
        report = {k: {"launches": 0} for k in SOURCES}
        with tempfile.TemporaryDirectory() as workdir:
            phase_serving_plane(report, workdir)
        print(json.dumps({k: report[k]["launches"] for k in SOURCES}))
        return 0

    def header(text):
        print(f"{text} ({time.monotonic() - t_start:.0f} s)")

    header("phase 1: build")
    probe = import_probe_start()
    phase_build()
    import_probe_finish(probe)
    report = {}
    header("phase 2: K1 fused_score vs plain")
    phase_k1(report)
    header("phase 3: K2 fused_trees vs plain")
    phase_k2(report)
    header("phase 4: main path (two services on the card vs CPU twins)")
    with tempfile.TemporaryDirectory() as workdir:
        phase_main_path(report, workdir)
    header("phase 5: timing (CUDA events)")
    phase_timing(report)
    print("services: " + json.dumps(report["services"]))
    header("phase 6: K3 level_hist and K4 level_hist_fused vs plain")
    phase_k3_k4(report)
    header("phase 7: K5 best_splits vs plain")
    phase_k5(report)
    header("phase 8: train main path (card vs CPU, then serve, posttrain "
           "and eval)")
    # phase 8's sets stay for phase 13's exports and encode
    with tempfile.TemporaryDirectory() as w8:
        phase_train_main_path(report, w8)
        phase_posttrain_eval(report, w8)
        header("phase 9: training timing at the HIGGS widths")
        phase_train_timing(report, t_start)
        # phase 10 runs in a process of its own beside phases 11-13
        with tempfile.TemporaryDirectory() as p10dir:
            p10 = background_start(p10dir, "--p10")
            try:
                header("phase 11: NN eval through K1 and posttrain, card "
                       "vs CPU")
                with tempfile.TemporaryDirectory() as workdir:
                    phase_nn_eval(report, workdir, rows=MAIN_NN_ROWS)
                    header("phase 12: NN/LR trainer on the card vs CPU, "
                           "eval through K1, multi-class, timing")
                    phase_nn_train(report, workdir)
                    header("phase 13: varselect, stats flags, export and "
                           "encode on the card vs the CPU twin")
                    phase_varselect_export(report, w8, workdir,
                                           se_full_rows=MAIN_NN_ROWS)
                header("phase 10: init -> stats -> norm on the card vs the "
                       "CPU twin (started with phase 11)")
                report["pipeline"] = background_finish(p10, "--p10")
            finally:
                background_stop(p10)
    # phase 20 runs in a process of its own beside phases 14-19
    with tempfile.TemporaryDirectory() as p20dir:
        p20 = background_start(p20dir, "--p20")
        try:
            header("phase 14: WDL, MTL and trainOnDisk on the card vs the "
                   "CPU twin")
            with tempfile.TemporaryDirectory() as workdir:
                phase_wdl_mtl_stream(report, workdir)
            main_phases_15_19(report, header)
            header("phase 20: parquet and scheme:// model sets and the tf "
                   "kind on the card (started with phase 14)")
            phase_remote_parquet_finish(report, p20)
        finally:
            background_stop(p20)
    print(f"total: {time.monotonic() - t_start:.1f} s on {smi}")

    kernels = []
    for k, (src, replaces) in SOURCES.items():
        r = report[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print("kernels: " + ", ".join(f"{k['name']}={k['launches']}"
                                  for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
