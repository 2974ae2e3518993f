"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA C++ kernels (csrc/*.cu, one nvcc for sm_90a
     per source, all started together) from the checkout, and prints the
     build seconds; cuobjdump -sass of the library
     must show tensor-core instructions (HMMA) in each bf16 tensor-core
     kernel (TENSOR_CORE_KERNELS), and wgmma (HGMMA) fed by TMA loads
     (UTMALDG) in the Hopper mainloop's (WGMMA_KERNELS).
  3. kernels: each kernel against its plain PyTorch version at every shape
     the eval steps give it (each fusion stream's length; the Swin stages
     over 33, 64 and 97 trunk rows), in fp32 and bf16, on live rows, with
     the stated tolerance; median kernel and plain times from CUDA events,
     beside the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time; the umse
     forward also by the profiler's device ms. The ffn
     forward at the vslt shape also with dropout 0.1 (bf16). swin_mlp at
     the main path's 33 trunk rows, bf16: each stage beside its plain
     version and bound, their totals weighted by a step's launches
     (2/2/6/2), and the dtype's split form timed at the widths its route
     runs fused (stages 1 and 2 in bf16, stage 1 in fp32).
     swin_attention at the main path's 33 trunk rows: at each stage and
     mask, bf16, the tensor-core route beside
     F.multi_head_attention_forward, and their totals weighted by the
     launches of a step (2/2/6/2 over the stages); stage 1 also through the
     three-launch tensor-core route.
  4. vslt_txt: tri_mbt_vsltcls on vslt+txt (the JAX package's
     bitxt_mbt_vsltcls alias; BASELINE config 2's own model is phase 15's
     bi_vslttxt_mbt_v1), TIE, full width, bf16, built by get_model with
     seeded random weights; Trainer.eval_step on seeded synthetic batches.
     Asserts the launch counts per step, that the probabilities are finite
     and match the plain path (and, tighter, in fp32), feeds them to the
     port's Evaluator, and times ms/step on both paths in turns.
  4b. config 4: the same for BASELINE config 4 (vslt+img+txt, one CXR per
     sample through the frozen Swin-T), over batches that take the
     presence-packed trunk and one that overflows it to the full batch;
     then a torch.profiler split of one step.
  5. config 5: one eval step of config 4 with --multiimages 1, the same
     checks, no timing.
  5b. umse backward: the backward kernel against torch_umse_bwd (its
     closed form in plain torch) at [64, 1000, 256], fp32 by Frobenius
     ratio, bf16 against the fp32 closed form within STEP_BF16_RATIO of the
     bf16 closed form's distance, bit for bit over two runs; events and
     device ms beside the closed form's and the autograd recompute's it
     replaces. dropout_masks at MASK_SHAPES (the main path's input dropout
     of three streams, a TP FFN's masks, both FFN masks of the vslt
     stream): bit for bit, keep rates within 5 sd, events and device ms,
     one kernel launched per call.
  6. training kernels: the training forward of attn_block and its backward,
     ffn with dropout and its backward, at each fusion stream's length in
     fp32 and bf16, against autograd of the plain versions on the same
     inputs (the cotangent zero on rows no later layer reads), forward on
     live rows and every gradient, the bf16 attn_block backward bit for
     bit the same over two runs at the vslt shape. Median kernel and plain
     ms of forward and backward, the
     bound, the library column. The ffn backward at [65536, 256]: its tile
     pass and its weight sums timed apart, the live-row share, the weight
     sums bit for bit the same over two runs.
  7. config 4 train: Trainer.train_step at full width (bf16, batch 64,
     --dropout 0.1, adamw) over seeded batches through the packed trunk
     and its overflow: launch counts per step, the shapes of its dropout
     masks (MASK_SHAPES' input entries), peak device memory; one
     step from identical weights on the kernel and the plain path, fp32
     and bf16 at dropout 0 and 0.1 (the plain path draws the same Philox
     masks): loss, every trainable parameter's gradient (bf16 held
     against the fp32 step) and the updated parameters; train ms/step on
     both paths in turns; a torch.profiler split of one kernel-path step,
     in which the umse forward and backward kernels and dropout_masks run
     as often as STEP_KERNELS says;
     20 steps on one batch, the loss finite and falling.
  8. vslt_txt train (tri_mbt_vsltcls, as phase 4): a few steps, launch
     counts, one step on both paths
     (fp32 and bf16, dropout 0.1); not timed.
  9. attention: the masked attention of the cross-modal layers, its lean
     form, its training form and its backward, against autograd of the
     plain version in fp32 (the FMA route) and bf16 (the tensor-core
     route): at both cross shapes ([64, 24] queries against [64, 128]
     keys with the txt key mask, and back with the vslt key mask) and at
     small shapes with no mask, a key mask with padding mid-sequence, an
     all-masked sample, a block mask, a self-attention with dead q tiles
     (compared on live rows) and the tile loop's edges (5 queries against
     300 keys, 130 against 7). Median kernel and plain ms (CUDA events
     around the call, host work included), the bound, and the library
     column at the cross shapes: one scaled_dot_product_attention call on
     the same inputs, and its backward (autograd.grad of that call); then
     the profiler's device ms per call of each form and of the library
     calls (the rest of the event time is the host's), and the kernels
     the calls launched, which must be the dtype's route's.
  10. cross transformer eval: cross_transformer_txt_vslt (carryforward
     vslt + BioBERT notes, full width, bf16) as phase 4: launch counts,
     probabilities against the plain path in bf16 and fp32, ms/step in
     turns.
  11. cross transformer train: as phase 7 for that model (no image trunk):
     launch counts, peak memory, ms/step in turns, a profiler split, 20
     steps on one batch, one step on both paths in fp32 and bf16 at
     dropout 0 and 0.1.
  12. rowmm: the row-skipping projections of tensor parallelism, forward
     and backward against autograd of their plain versions in fp32 (the
     FMA route) and bf16 (the tensor-core route): the LN-fused form at one
     rank's q|k|v width under --mp-size 2 (x [65536, 256], W [256, 384])
     and at the single-device width (W [256, 768]), timed as it returns
     q, k and v, the plain form at [65536, 256] x [256, 768] beside
     torch.addmm; block flags from TIE lengths. Then the profiler's device
     ms per call of each form (lean, training, backward; and of
     torch.addmm and its backward), and the kernels the calls launched,
     which must be the dtype's route's. Phase 9 also runs the
     attention at the tensor-parallel self shapes of the three streams
     ([64, L, 2, 64], L = 1024 with the TIE key mask, 133, 54) and at
     phase 22's rank shapes (the cross layers' q [64, 24, 2, 64] against
     kv [64, 128, 2, 64] and back; tri_mbt_vmulti's vslt stream [64,
     1016, 2, 64] under its 3-D block mask) beside
     scaled_dot_product_attention.
  13. tensor parallelism: config 4 under --mp-size 2 --dp-size 1, at
     TP_LAYERS (2) of its 6 layers, in two
     ranks (parallel.launch) that share the one card over gloo, weights
     seeded as the single-process run: eval probabilities against the
     single-process kernel path (bf16 and fp32), one fp32 train step at
     dropout 0.1 (every gradient, gathered, against the single process's),
     the same step in bf16 held against the fp32 plain step as the single
     process's bf16 step is (within STEP_BF16_RATIO of its errors),
     launch counts per rank, ms/step and peak memory per rank (two ranks on
     one card: not a speed figure of tensor parallelism), a profiler split
     with gloo's share, 32 steps on one batch with the mean loss of the
     last 8 below that of the first 8.
  14. drivers: config 4 through the train driver's fold
     (drivers.train.run_fold) at full width, bf16, --dropout 0.1, adamw,
     over seeded synthetic loaders in the real loader's wire format (uint8
     CXRs packed at --img-pack-frac 0.55, notes as txt_id rows into a
     TxtTable of the batches' notes): 2 epochs of 4 train batches, 2 val
     and 2 test batches, --checkpoint-every 3, --log-iter 1. Checks the
     launch counts of the run (8 train steps and 6 eval steps of config
     4), the run record (8 finite train losses, 2 validation blocks,
     settings.txt, last and best), the step-3 async save (written while
     steps 4-8 ran) against a Trainer stepped 3 times on the same batches,
     bit for bit; a batch's dense and wire forms (packed, and over the
     capacity) to the same probabilities bit for bit, and a batch of TIE
     lengths <= 256 at bucket 256 against full length (PROB_TOL bf16); the
     test driver's walk to the train driver's final test metrics exactly;
     --resume last --epochs 3: the state right after the restore equal to
     the file's bit for bit, the LR of its step, and the run to its end.
     Prints the driver's ms/step (events clock) beside phase 7's, the
     main thread's ms per async save beside save_checkpoint, the
     checkpoint's MB, the run's peak memory and the phase's seconds.
  15. the BASELINE configs' own models, full width, bf16 (tools/
     golden_parity.py:57-113). Config 1 (unimodal_transformer, vslt only,
     TIE: one stream of 6 layers, 1001 rows padded to 1024): eval as phase
     4 (ms/step in turns), train as phase 7 (launch counts, peak memory,
     ms/step in turns, a profiler split with the idle share, 20 steps on
     one batch, one step on both paths in fp32 and bf16 at dropout 0 and
     0.1); --remat 1 against --remat 0 (one fp32 step at dropout 0.1:
     the loss equal, every gradient within REMAT_TOL by Frobenius ratio,
     each layer's forward launched twice; the peak memory of both, fp32
     and bf16); QIE and carryforward eval against the plain path with
     launch counts (carryforward launches no umse); the train driver's
     fold (1 epoch of 4 train, 2 val, 2 test batches) and the test
     driver's walk to its final test metrics exactly. Config 2
     (bi_vslttxt_mbt_v1), config 3 (bi_vsltimg_mbt_v1, vslt+img,
     fullmodal: every image present, the trunk over all 64 rows) and
     tri_mbt_v1 (config 4's flags): eval against the plain path in bf16
     and fp32, one train step on both paths (fp32 and bf16, dropout 0.1),
     launch counts. Prints the phase's seconds.
  16. the multitoken MBT family (config 4's flags, full width, bf16, the
     trunk over all 64 rows, unpacked). First the attention block under
     the streams' 3-D block masks (models/mbt.py::block_key_mask, seeded
     lengths, samples without a note: rows with every key masked) at
     [64, 1016 / 63 / 142, 256] (vslt / img / txt) and the VSLTMAIN img
     and txt streams' [64, 61 / 140, 256], fp32 and bf16: the lean form,
     the training form and the backward against the plain version
     (every row, every gradient by Frobenius ratio), event and plain ms,
     the bound, the profiler's device ms per form and the launched
     kernels (the dtype's route's, in their block-mask instantiations);
     each mask's tile map (the card's against block_tile_map, bit for bit;
     its dead and full shares; block_tile_map_kernel's device ms, built
     in each bf16 call and counted in the forms' times), and at the vslt
     shape the bf16 forms beside their readings before the tile map
     (EARLIER_MS) and the 2-D key-mask form's device ms at the same shape.
     Then tri_mbt_vmulti, tri_mbt_vmulti2 and tri_mbt_vmultivslt: eval as
     phase 4 (the selected probabilities in bf16 and fp32, and every
     head's [4, B] probabilities), one train step on both paths in fp32
     and bf16 at dropout 0 and 0.1, launch counts (attn_block_3d 18 +
     bwd 18; 16 backward for tri_mbt_vmultivslt); tri_mbt_vmulti also
     timed in turns, profiled (with the tile maps the step built), its
     peak memory, 20 steps on one batch and
     a fold through the train driver (1 epoch of 2 train, 1 val and 1
     test batch) with the test driver's walk to its final test metrics.
     Prints its train ms/step beside config 4's and the phase's seconds.
  3w. the kernels at the other model widths (WIDTH_CASES: d_model 128
     with 4 heads, 512 with 4 heads, 256 with 2 heads; d_head 32, 128,
     128): umse at D 512 (forward against torch_umse, backward against
     its closed form); attn_block at [64, 1024, C] under the TIE key mask
     and at [64, 142, C] under a multitoken txt stream's 3-D block mask
     (lean, training, backward); ffn at C 128 (fused) and 512 (the split
     route, csrc/ffn_split.cu; in bf16 on csrc/wgmma.cuh), dropout 0.1,
     training and backward, and at 512 its masks held to dropout_masks'
     bit for bit (every dropped output is x, every dropped hidden unit
     0), the bf16 backward bit for bit over two runs, both forms beside
     their readings before the wgmma mainloop (EARLIER_MS) and kernel by
     kernel (the forward at dropout 0.1 and 0, the backward); rowmm at
     Cin 128 and 512
     (the LN form at one rank's q|k|v, W [C, 3C/2], and the plain form);
     the masked attention at d_head 128 (the TIE stream's TP self shape,
     the cross shapes, a block mask, no mask). fp32 and bf16 against the
     plain versions with phase 3's and 6's tolerances, event ms, the
     profiler's device ms per form with the launched kernels (the dtype's
     route's), plain ms and the bound; the library column where one
     PyTorch call computes the same (scaled_dot_product_attention at the
     TP self and cross shapes, torch.addmm for the plain rowmm).
  14b. the drivers under --mp-size 2 --dp-size 1: two ranks
     (parallel.launch) sharing the one card over gloo, each through the
     drivers' set-up (drivers/common.py::setup_distributed: the group,
     cuda:0, the mesh), config 4 at full width (TP_LAYERS layers): the
     train driver's fold
     (1 epoch of 2 train, 1 val and 1 test wire-format batches, the epoch
     save), the fold again under --resume last, the test driver's walk.
     Checks the launch counts per rank, the run record rank 0 wrote and
     nothing else in the run's directory, the walk to the fold's final
     test metrics; rank 0's best checkpoint loaded into a single-process
     Trainer scores the test batch to the ranks' probabilities within
     PROB_TOL bf16 (phase 13's bound). Prints rank 0's ms/step (events
     clock; TP_LABEL).
  17. config 4 at the other widths (WIDTH_CASES; the rest as the
     flagship's: bf16, batch 64, TIE-len 1000, 6 layers, --dropout 0.1,
     adamw): eval launch counts (every attn_block, ffn and umse call on
     its kernel), probabilities against the plain path in bf16 and fp32
     (phase 4's bounds), ms/step in turns; train launch counts, peak
     memory, ms/step in turns (at C 512 a profiled step: device time by
     kernel and the idle share), one step on both paths in fp32 and bf16
     at dropout 0.1 (phase 7's gates).
  18. the rest of the paper's MBT registry on config 4's flags (full
     width, bf16; the bimodal names on their own --input-types): first
     attn_block and the ffn at the concat fusion's joint shape [64, 1179,
     256] (cls, 1000 TIE rows, image cls and 49 rows, 128 note rows; no
     row tile skipped) under its key mask, training forward and backward
     against the plain version as phase 6 holds them (fp32 and bf16, event
     and plain ms, the profiler's device ms and launched kernels, the
     bound); then tri_mbt_vsltcls_noshareumse,
     tri_mbt_vflexible / 2 / 3, tri_mbt_vnoshavgtr / vnoshnoavgtr,
     tri_mt_v1, mt_v1, biimg_mt_v1 and bitxt_mt_v1: eval against the plain
     path in bf16 and fp32, one train step on both paths in fp32 and bf16
     at dropout 0 and 0.1 (phase 7's gates), launch counts per step
     (LAUNCHES_PER_STEP / TRAIN_LAUNCHES_PER_STEP), the vflexible
     models' learned weights set off zero (FLEX_WEIGHTS); tri_mbt_vflexible and
     tri_mt_v1 also timed in turns, profiled (device busy, idle share),
     their peak memory and 20 steps on one batch; biimg_mbt_vflexible1
     and bitxt_mbt_vflexible1 refused by name. Then --model-types
     classification (tri_mbt_vsltcls, config 4's flags): each of the five
     --loss-types (softmax, bces and bceandsoftmax at 12 outputs, rmse and
     bce at 1) eval against the plain path and one train step on both
     paths (fp32 and bf16, dropout 0.1), and bceandsoftmax through the
     train driver's fold over wire batches (1 epoch of 2 train, 1 val, 1
     test; launch counts) and the test driver's walk to its final test
     metrics. Prints the phase's seconds.
  19. the paper's baselines and the trainable Swin trunk (full width,
     bf16): first the trunk's two ops at each Swin-T stage at batch 64
     through their autograd Functions (the kernel's training forward, the
     backward kernels swin_attention_bwd and swin_mlp_bwd) against
     autograd of the plain version, the backward kernels against their
     closed forms and bit for bit over two runs, with the profiler's
     device ms of the eval forward, the training forward, the backward
     (its kernels), the plain recompute it replaced and, for the
     attention, autograd of torch's multi_head_attention_forward; per
     step weighted by the launches; the stochastic-depth blocks' unfused
     MLP branch (plain) forward and backward; stochastic depth's row masks on the
     card bit for bit the plain version's, the keep rate of 1M rows;
     attn_block and the ffn at feature_temporal_v1's unmasked instance
     shape [1536, 19, 256] (fp32 and bf16, as phase 18's joint shape);
     the trunk alone (eval forward, training forward, backward, peak
     memory). Then gru_d, lstm and feature_temporal_v1 (carryforward),
     fusiontrainer (Medfuse, MMTM, DAFT; vslt_img_txt carryforward),
     tri_mbt_v2, tri_mbt_v3 and tri_mbt_vsltcls --img-pretrain No
     (config 4's flags): eval against the plain path in bf16 and fp32,
     one train step on both paths in fp32 and bf16 at dropout 0.1 (phase
     7's gates, every trunk gradient by Frobenius ratio), launch counts
     per step (BASELINES' tables; no plain recompute); fusiontrainer
     Medfuse and tri_mbt_v2 timed in turns and profiled (device busy,
     idle share) with their peak memory; one step under --fusion-type
     uni_ehr (no trunk backward); a fusiontrainer fold through the drivers and
     gru_d's with no --model (1 epoch of 2 train, 1 val, 1 test) with the
     test driver's walk. Prints the phase's seconds.
  20. the legacy families of register_legacy (full width, bf16,
     LEGACY_RUNS: the carryforward grid, the 36-row pretrain windows of
     --auxiliary-loss-input for auxcpc_*, BioBERT notes, CXRs through the
     trainable Swin-T, the image archetypes also on ResNet-18, the GRU-D
     mid fusion on ResNet-50, the image classifiers on ResNet-18, ViT-B/16,
     MaxViT, Swin-T and the patch stem, the MBT aliases on config 4's
     flags; a name that builds another's model from the same flags,
     tests/test_torch_legacy_models.py::TWINS, runs as that name): first
     the masked attention at the image cross transformer's shapes (49
     image keys, all valid, and back) beside scaled_dot_product_attention,
     attn_block at the early fusion's [64, 202, 256] joint stream and the
     time transformer's [64, 25, 256] (fp32 and bf16, the profiler's
     device ms per form); then per run an eval step against the plain
     path in bf16 and fp32, a train step at --dropout 0.1 (launches
     against LEGACY_EVAL / LEGACY_TRAIN, no plain recompute, peak
     memory), one step on both paths in fp32 and bf16 at dropout 0 (phase
     15's step gates, with LG_ALLOW's allowances for the runs it names);
     one run per archetype (LEGACY_TIMED) timed in turns and profiled; a
     TIE stream refused. Prints the phase's seconds.
  21. data parallelism: (c) first, the kernels that draw dropout masks at a
     data rank's row offset (row0 = 32 x 1024, the second rank's half of
     the vslt rows; ROW0_SHAPES, bf16 and fp32): dropout_masks bit for bit
     against the plain version at row0 and against those rows of the
     whole batch's masks; the ffn forward (p 0.1, the TIE stream's tile
     flags) bit for bit against the whole batch's call on those rows,
     within TOL of its plain version, every element its plain output mask
     drops exactly x; its backward's dx bit for bit against the whole
     batch's, its gradients within GRAD_TOL of autograd of the plain
     version; the split route at C 512; each form's event and device ms
     beside row0 = 0. Then (a) config 4 at full width through the train
     driver's fold (4 train batches, 1 val, 1 test; --dropout 0.1, adamw)
     and the test driver's walk, bf16 and fp32, in two gloo ranks of
     dp_rank (parallel.launch, --dp-size 2, both on cuda:0) and in this
     process on the same global batches from the same seeded weights
     (DP_RUNS); (b) the same at --dp-size 2 --mp-size 2 in four ranks at
     TP_LAYERS layers (2 train batches); the ranks of (a) and (b) run at
     once, after the single process's folds. Gates (_dp_check): every
     step's loss, each rank's launches per step (and the single process's
     under (a)), the walk's probabilities (fp32 DP_PROB_FP32, bf16
     PROB_TOL or the single process's noise floor), the state after the
     steps by phase 7's Frobenius rules (the first Adam moments in the
     gradients' place, and the parameters' updates; fp32 DP_STATE_FP32);
     prints each rank's ms/step (events clock) beside the single
     process's, its peak memory, the phase's seconds.
  22. tensor parallelism for every family (TPALL_RUNS, --mp-size 2, full
     width, batch 64, --dropout 0.1, adamw, seeded weights): config 4 at
     all 6 layers at C 256, and at C 128 and 512 at TPALL_WIDE_LAYERS (2)
     of them (4 heads: d_head 64, 32, 128; the row-skipping projection at
     Cin 256, 128, 512), the cross transformer
     (the cross layers on a rank's heads), tri_mbt_vmulti (the 3-D block
     mask on a rank's heads), tri_mt_v1, tri_mbt_v2 --img-pretrain No,
     unimodal_transformer --remat 1 and auxcpc_mbt (cpcWbrl), in two gloo
     ranks of tpall_rank sharing the card, two launches at once (the runs
     of TPALL_GROUPS, each group's in turn), while this process runs each
     on one process from the same weights on the same batch. Gates (_tpall_check): each rank's launches per eval and train
     step against the run's tables; fp32 eval probabilities, the train
     step's loss and every gathered gradient as phase 13's; bf16
     probabilities within PROB_TOL or phase 21's noise-floor rule, the
     loss; the ranks' replicated state equal bit for bit. Prints rank 0's
     train ms/step per run (TP_LABEL) and the phase's seconds.
The kernel phases (3, 5b, 6, 9, 12, 3w) run first, then 4-5, 7-8, 10-11,
13, 14, 14b, 15, 16, 17, 18, 19, 20, 21 and 22 (phase 22's ranks start
with phase 21's (a) and run beside it), with the run's clock after each
group.
Then one JSON line per the kernels (each with the path that launches it
and its launches over that path's steps, under ``other_paths`` its
launches on phases 15, 16, 18, 19 and 20's other train paths, under
``widths`` its bf16 results at the other widths of phase 3w, under
``mt_joint`` its bf16 results at phase 18's joint shape, and under
``baselines`` phase 19's: the Swin ops' training forward at stage 1 with
the step totals (their backward kernels have lines of their own, from
the same phase, launches from tri_mbt_v2's train steps), attn_block and
the ffn at feature_temporal_v1's shape, under ``legacy`` phase 20's:
the attention at 49 image keys, attn_block at the joint stream, with the
other shapes under ``other_shapes``; under ``row0`` phase 21's row-offset
forms of dropout_masks and the ffn; under ``tpall`` phase 22's launches
per train step and rank by run; under ``tp_shapes`` phase 9's results at
phase 22's rank shapes) and, last, {"ok": true, "device": ...}.

    python3 chip_smoke.py tpall

runs the build and phase 22 alone;

    python3 chip_smoke.py dp

runs the build and phase 21 alone;

    python3 chip_smoke.py baseline

runs the build and phase 15 alone;

    python3 chip_smoke.py multitoken

the build and phase 16;

    python3 chip_smoke.py registry

the build and phase 18;

    python3 chip_smoke.py baselines

the build and phase 19;

    python3 chip_smoke.py legacy [RUN ...]

the build and phase 20 (the runs of LEGACY_RUNS named, or all);

    python3 chip_smoke.py legacyprobe

the build and the image cross transformer's bf16 step at dropout 0: each
masked attention call's dq, dk, dv by the kernel and by the plain path in
bf16, against the plain path in fp32 on the same recorded inputs, over
the samples with a CXR and those without;

    python3 chip_smoke.py widths

the build, phase 3w and phase 17;

    python3 chip_smoke.py tpdrivers

the build and phase 14b;

    python3 chip_smoke.py gradprobe

the build and the fp32 train step's gradient errors at phase 17's widths
and the flagship's, against the plain path's own under a one-rounding
nudge of the weights;

    python3 chip_smoke.py keyprobe

the build and the fp32 step at C 512 / 4 heads, dropout 0: its worst
key_proj weight gradient against the plain path with one kernel at a
time on its plain version (KEYPROBE_SWAPS), that error's share in its
first singular value, and the attention block and the FFN alone at that
width against float64, kernel and plain path each.

    python3 chip_smoke.py trunkprobe

the build and phase 19's bf16 step gate of --img-pretrain No: the kernel
path, the plain path and the kernel path with one group of wrappers at a
time on its plain version (TRUNKPROBE_SWAPS), each against the fp32
plain step, over every tensor, the trunk's and the rest; then both paths
from the weights nudged by half a bf16 rounding, twice.

    python3 chip_smoke.py ab ROOT

reads the device ms of the ffn forward, swin_mlp, the four rowmm forms,
the attention block's kernels, the dropout masks and the umse forward and
backward as a config-4 step calls them, and a config-4 train step's
device busy time and peak memory, for the package under ROOT (``ab``), to
compare two trees (git archive copies) in turns on one card.

    python3 chip_smoke.py stepgate [ROOT]

reads phase 16's bf16 step gate of tri_mbt_vmultivslt at dropout 0 on
STEPGATE_SEEDS batches (phase 16 takes the first): per batch, the kernel
path's and the plain path's gradient errors against the fp32 plain step
(median, largest and the two worst tensors), and the largest's share of
the gate's bound, for the package under ROOT (this tree by default).

    python3 chip_smoke.py saver

reads the async saver's cost to the config-4 train steps it overlaps:
the steps with no save in flight, then per form of its writer (as it
is; a clone per tensor, its first design; the zip's CRC32 off) the main
thread's ms per save call and the six steps after it, in turns.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

BATCH = 64
TIE_LEN = 1000
VSLT_TXT = [
    "--model", "tri_mbt_vsltcls", "--input-types", "vslt_txt",
    "--vslt-type", "TIE", "--imgtxt-time", "1",
    "--output-type", "intubation",
    "--modality-inclusion", "train-missing_test-missing",
    "--batch-size", str(BATCH),
]
CONFIG4 = [a if a != "vslt_txt" else "vslt_img_txt" for a in VSLT_TXT]
CONFIG5 = CONFIG4 + ["--multiimages", "1"]
# the cross-modal transformer over carryforward vital signs (window 24, 16
# channels plus age and gender) and BioBERT notes (128 x 768): 3 self
# layers per stream, then 3 bidirectional cross layers
CROSS = [
    "--model", "cross_transformer_txt_vslt", "--input-types", "vslt_txt",
    "--vslt-type", "carryforward", "--output-type", "intubation",
    "--modality-inclusion", "train-missing_test-missing",
    "--batch-size", str(BATCH),
]
# phase 15, the BASELINE configs' own models (tools/golden_parity.py:57-
# 113): config 1, unimodal_transformer over the TIE stream; config 2,
# bi_vslttxt_mbt_v1 (phases 4 and 8 run VSLT_TXT: tri_mbt_vsltcls on
# vslt_txt, the JAX package's bitxt_mbt_vsltcls alias); config 3,
# bi_vsltimg_mbt_v1 on one CXR per sample under fullmodal; tri_mbt_v1 on
# config 4's flags
CONFIG1 = ["--model", "unimodal_transformer", "--input-types", "vslt",
           "--vslt-type", "TIE", "--output-type", "intubation",
           "--modality-inclusion", "train-missing_test-missing",
           "--batch-size", str(BATCH)]
BASE2 = [a if a != "tri_mbt_vsltcls" else "bi_vslttxt_mbt_v1"
         for a in VSLT_TXT]
BASE3 = ["--model", "bi_vsltimg_mbt_v1", "--input-types", "vslt_img",
         "--vslt-type", "TIE", "--imgtxt-time", "1",
         "--output-type", "intubation",
         "--modality-inclusion", "train-full_test-full",
         "--batch-size", str(BATCH)]
TRI_V1 = [a if a != "tri_mbt_vsltcls" else "tri_mbt_v1" for a in CONFIG4]
# present-image fractions of the batches: vslt_txt has no images; config 4
# packs 32 and 16 of 64 images (capacity 32, so 33 trunk rows) and
# overflows with 48 (64 rows); config 5 holds 1-3 images in 32 samples
# (at most 96 slots, the capacity of its 192 rows)
BATCHES = {"vslt_txt": [0.5] * 3, "config4": [0.5, 0.25, 0.75],
           "config5": [0.5], "cross": [0.5] * 3,
           # phase 15: config 3 has every image (fullmodal, the trunk over
           # all 64 rows), tri_mbt_v1 config 4's packed and overflowing
           # batches
           "config1": [0.5] * 3, "config1_qie": [0.5], "config1_cf": [0.5],
           "base2": [0.5] * 2, "base3": [1.0] * 2,
           "tri_v1": [0.5, 0.75]}
# per eval step: one TIE embedding; one attention and one FFN half per
# layer per stream (6 layers x {vslt, txt} or {vslt, img, txt}); one
# window attention and one MLP per Swin block (2 + 2 + 6 + 2)
LAUNCHES_PER_STEP = {
    "vslt_txt": {"umse": 1, "attn_block": 12, "ffn": 12},
    "config4": {"umse": 1, "attn_block": 18, "ffn": 18,
                "swin_attention": 12, "swin_mlp": 12},
}
LAUNCHES_PER_STEP["config5"] = LAUNCHES_PER_STEP["config4"]
# the cross transformer: an attention and an FFN half per self layer and
# stream (3 x 2), an attention and an FFN per cross layer and direction
# (3 x 2)
LAUNCHES_PER_STEP["cross"] = {"attn_block": 6, "ffn": 12, "attention": 6}
# phase 15: config 1 runs one stream of 6 layers (1001 rows padded to
# 1024); its carryforward grid needs no umse; the v1 models as configs 2
# and 4, config 3 as config 4 without the notes
LAUNCHES_PER_STEP.update(
    config1={"umse": 1, "attn_block": 6, "ffn": 6},
    config1_cf={"attn_block": 6, "ffn": 6},
    base2=LAUNCHES_PER_STEP["vslt_txt"],
    base3={"umse": 1, "attn_block": 12, "ffn": 12, "swin_attention": 12,
           "swin_mlp": 12},
    tri_v1=LAUNCHES_PER_STEP["config4"])
LAUNCHES_PER_STEP["config1_qie"] = LAUNCHES_PER_STEP["config1"]
# per train step: the forward's launches; the TIE embedding's backward; a
# backward per fusion layer and
# stream whose output the loss reaches (the last layer's non-vslt streams
# feed only the bottleneck mix, which nothing reads after the last layer,
# so autograd runs no backward for them: 16 of 18, 11 of 12); one
# dropout_masks per stream for the input dropout at --dropout 0.1 (the
# FFN's masks are drawn inside its kernels)
TRAIN_LAUNCHES_PER_STEP = {
    "vslt_txt": {"umse": 1, "umse_bwd": 1, "attn_block": 12,
                "attn_block_bwd": 11, "ffn": 12, "ffn_bwd": 11,
                "dropout_masks": 2},
    "config4": {"umse": 1, "umse_bwd": 1, "attn_block": 18,
                "attn_block_bwd": 16, "ffn": 18, "ffn_bwd": 16,
                "dropout_masks": 3, "swin_attention": 12, "swin_mlp": 12},
}
# the cross transformer's both streams reach the head through their
# pooled features, so every layer gets its backward
TRAIN_LAUNCHES_PER_STEP["cross"] = {
    "attn_block": 6, "attn_block_bwd": 6, "ffn": 12, "ffn_bwd": 12,
    "attention": 6, "attention_bwd": 6}
# phase 15: config 1's head reads the cls row, which attends to every
# layer's stream, so every layer gets its backward; the v1 heads read
# every stream's cls token (a mix of the two vectors, or of per-stream
# logits), so the last layer's img and txt streams get theirs too (12 of
# 12, 18 of 18); one input-dropout mask per stream
TRAIN_LAUNCHES_PER_STEP.update(
    config1={"umse": 1, "umse_bwd": 1, "attn_block": 6,
             "attn_block_bwd": 6, "ffn": 6, "ffn_bwd": 6,
             "dropout_masks": 1},
    base2={"umse": 1, "umse_bwd": 1, "attn_block": 12,
           "attn_block_bwd": 12, "ffn": 12, "ffn_bwd": 12,
           "dropout_masks": 2},
    base3={"umse": 1, "umse_bwd": 1, "attn_block": 12,
           "attn_block_bwd": 12, "ffn": 12, "ffn_bwd": 12,
           "dropout_masks": 2, "swin_attention": 12, "swin_mlp": 12},
    tri_v1={"umse": 1, "umse_bwd": 1, "attn_block": 18,
            "attn_block_bwd": 18, "ffn": 18, "ffn_bwd": 18,
            "dropout_masks": 3, "swin_attention": 12, "swin_mlp": 12})
# the plain recomputes a train step runs (ops.recomputes: a Swin op's
# backward as autograd of its plain version), by path: none, since the
# trainable trunk's backward launches the backward kernels
TRAIN_RECOMPUTES_PER_STEP = {}
TRAIN_BATCHES = {"vslt_txt": [0.5, 0.5], "config4": [0.5, 0.25, 0.75],
                 "cross": [0.5] * 3, "config1": [0.5] * 3,
                 "base2": [0.5] * 2, "base3": [1.0] * 2,
                 "tri_v1": [0.5, 0.75]}
DROPOUT_SEED = 20231016

# tolerances |kernel - plain| <= atol + rtol * |plain|, on live rows.
# fp32: both sides accumulate in fp32 in another order (C up to 768 and
# L = 1024 terms), so differences stay near 1e-5 of O(1) values.
# bf16: both sides round to bf16 at the same points, but a different
# accumulation order can flip a rounding by one unit (2**-8 relative) in
# q/k/v or the hidden layer, and the attn_block kernel's flash loop rounds
# its probabilities to bf16 before it divides by the row sum (as the TPU
# kernel does) where the plain version rounds them after; an output of
# O(4) has a last unit of 2**-5.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 2e-2)}
# probabilities of the whole step: fp32 within 1e-4; bf16 within 5e-2,
# the drift of bf16 rounding flips through the trunk, six layers and the
# head.
PROB_TOL = {"fp32": 1e-4, "bf16": 5e-2}
# gradients: |kernel - plain|_F / |plain|_F per tensor (the largest
# element difference over the largest plain entry is printed beside it).
# A ReLU pre-activation within rounding of 0 takes the other branch on one
# side (about 50 of the 67M hidden units of the vslt FFN in fp32, measured
# as a 2e-2 max-element gap in dx and 7e-3 in dW1, with dW2 within 1e-6):
# each such unit moves one row of dx and one column of dW1 by a few
# percent, which the Frobenius ratio weighs by their share. fp32: the same
# math summed in another order, plus those flips. bf16: the plain version
# is autograd of a bf16 graph, which rounds every intermediate gradient to
# bf16 (2**-9 relative) where the kernels keep fp32 and round where the
# TPU kernels do.
GRAD_TOL = {torch.float32: 5e-3, torch.bfloat16: 5e-2}
# a whole train step from the same weights, kernel vs plain path, per
# trainable tensor with a nonzero true gradient, as GRAD_TOL: fp32 within
# 1e-2 (six layers of such flips, the head's BatchNorm over 64 samples).
# bf16 gradients of this model lie 0.1-0.2 from the fp32 ones on either
# path, so each bf16 path is held against the fp32 plain step at the same
# dropout: the kernel path's median and largest errors must stay within
# STEP_BF16_RATIO of the plain path's (plus 1e-2). The loss within 1e-4
# (fp32) and 2e-2 (bf16) absolute.
STEP_FP32_TOL = 1e-2
STEP_BF16_RATIO = 1.5
STEP_LOSS_TOL = {"fp32": 1e-4, "bf16": 2e-2}

KERNEL_SOURCES = {
    "umse": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/umse.cu",
             "medical_tri_modal_pilot_tpu/kernels/umse.py:100"),
    # the JAX package's umse gradient is jax.vjp of xla_umse in its custom
    # VJP's backward (no pallas_call of its own)
    "umse_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/umse.cu",
                 "medical_tri_modal_pilot_tpu/kernels/umse.py:132"),
    "attn_block": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block.cu",
                   "medical_tri_modal_pilot_tpu/kernels/attn_block.py:245"),
    "ffn": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/ffn.cu",
            "medical_tri_modal_pilot_tpu/kernels/ffn.py:266"),
    "swin_attention": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_attention.cu",
        "medical_tri_modal_pilot_tpu/kernels/swin_attention.py:162"),
    "swin_mlp": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_mlp.cu",
                 "medical_tri_modal_pilot_tpu/kernels/swin_mlp.py:101"),
    # the weight-gradient sums of both backward kernels run in
    # csrc/wgrad.cu
    "attn_block_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block_bwd.cu",
        "medical_tri_modal_pilot_tpu/kernels/attn_block.py:577"),
    # the 3-D block-mask forms of the same two pallas_calls (their
    # branches at :219-227 and :558-566), phase 16
    "attn_block_3d": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block.cu",
        "medical_tri_modal_pilot_tpu/kernels/attn_block.py:245"),
    "attn_block_3d_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block_bwd.cu",
        "medical_tri_modal_pilot_tpu/kernels/attn_block.py:577"),
    "ffn_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/ffn.cu",
                "medical_tri_modal_pilot_tpu/kernels/ffn.py:298"),
    "dropout_masks": ("cuda",
                      "medical_tri_modal_pilot_tpu_torch/csrc/dropout.cu",
                      "medical_tri_modal_pilot_tpu/kernels/ffn.py:230"),
    "attention": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attention.cu",
                  "medical_tri_modal_pilot_tpu/kernels/attention.py:257"),
    "attention_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attention.cu",
        "medical_tri_modal_pilot_tpu/kernels/attention.py:431"),
    # the backward kernels' weight sums run in csrc/wgrad.cu
    "rowmm_ln": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                 "medical_tri_modal_pilot_tpu/kernels/rowmm.py:240"),
    "rowmm_ln_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                     "medical_tri_modal_pilot_tpu/kernels/rowmm.py:269"),
    "rowmm": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
              "medical_tri_modal_pilot_tpu/kernels/rowmm.py:182"),
    "rowmm_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                  "medical_tri_modal_pilot_tpu/kernels/rowmm.py:208"),
    # the Swin ops' custom VJPs take jax.vjp of their XLA oracles (no
    # pallas_call of their own); the dense products around the window core
    # run in torch.matmul, the MLP's weight sums in csrc/wgrad.cu
    "swin_attention_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_attention_bwd.cu",
        "medical_tri_modal_pilot_tpu/kernels/swin_attention.py:193"),
    "swin_mlp_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_mlp_bwd.cu",
        "medical_tri_modal_pilot_tpu/kernels/swin_mlp.py:133"),
}
# the path whose train steps give each kernel's launches in the kernels
# line: the masked attention runs in the cross transformer, the LN-fused
# projection under tensor parallelism, the plain projection on no path
# (the JAX package dispatches it nowhere), the Swin backwards where the
# trunk trains (tri_mbt_v2), every other kernel in config 4
KERNEL_PATHS = {name: "cross" if name.startswith("attention") else "config4"
                for name in KERNEL_SOURCES}
KERNEL_PATHS.update(rowmm_ln="tp", rowmm_ln_bwd="tp", rowmm=None,
                    rowmm_bwd=None, attn_block_3d="vmulti",
                    attn_block_3d_bwd="vmulti", swin_attention_bwd="v2",
                    swin_mlp_bwd="v2")

# the bf16 kernels on the tensor cores: each must compile to HMMA
TENSOR_CORE_KERNELS = ("swin_fused_kernel", "window_attn_tc_kernel",
                       "gemm_bf16_kernel", "ffn_bwd_tc_kernel",
                       "wgrad_tc_kernel", "block_qkv_tc_kernel",
                       "block_attn_tc_kernel", "block_dkv_tc_kernel",
                       "block_dq_tc_kernel", "block_ln_bwd_tc_kernel",
                       "attention_fwd_tc_kernel", "attention_dkv_tc_kernel",
                       "attention_dq_tc_kernel", "ffn_fwd_tc_kernel",
                       "swin_mlp_tc_kernel", "swin_fc1_tc_kernel",
                       "rowmm_tc_kernel", "rowmm_bwd_tc_kernel",
                       "window_attn_bwd_tc_kernel")
# the kernels of the Hopper mainloop (csrc/wgmma.cuh; the ffn's bf16 split
# route): each must compile to wgmma (HGMMA) fed by TMA loads (UTMALDG)
WGMMA_KERNELS = ("wg_gemm_kernel",)
# swin_attention launches per config-4 step at each stage, with and without
# the shift mask (Swin-T's depths 2/2/6/2 alternate unshifted and shifted
# blocks; stage 4, one window per image, has no shift)
SWIN_STAGE_LAUNCHES = [{"mask": 1, "none": 1}, {"mask": 1, "none": 1},
                       {"mask": 3, "none": 3}, {"none": 2}]
# swin_mlp launches per config-4 step at each stage (one per block)
SWIN_MLP_LAUNCHES = [2, 2, 6, 2]

# Philox4x32-10, the dropout masks' work, on the integer multiply pipe: a
# draw is ten rounds of two 32 x 32 -> 64-bit products, each two 32-bit
# multiply results (mul.lo and mul.hi, one IMAD.WIDE), so 40 results per
# four mask bytes; its xors and the compares run on the ALU pipe beside
# them
PHILOX_OPS_PER_BYTE = 10
# 32-bit integer multiply results a second: the CUDA C Programming Guide's
# arithmetic-instruction throughput table gives compute capability 9.0 64
# a clock per SM; 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAK_INT_OPS = 64 * 132 * 1.98e9
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them
# (both counting an FMA as two), HBM3 bandwidth; int32: PEAK_INT_OPS
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int32: PEAK_INT_OPS}
PEAK_BYTES = 3.35e12
# Swin-T stages at 224 x 224: (map side, C, windows per image, whether the
# stage has shifted blocks)
SWIN_STAGES = [(56, 96, 64, True), (28, 192, 16, True), (14, 384, 4, True),
               (7, 768, 1, False)]
# trunk rows of config 4's packed batches (the main-path shapes), of its
# overflowing batch, and of config 5's packed batch
TRUNK_ROWS = (33, 64, 97)
# rows per sample of the fusion streams: vslt, txt, one image, three image
# slots (bottlenecks and cls included)
STREAM_LENGTHS = (1024, 133, 54, 152)
# dropout_masks at the main path's shapes (R, F, C, col0): config 4's MBT
# input dropout of its three streams ([64, L, 256] with the cls token,
# before the 4 bottleneck rows: L = 1020 (TIE, padded), 129, 50; F = 0; 3
# launches a train step); under --mp-size 2 each FFN's masks (rank 1's 512
# hidden columns from 512, here at the vslt stream's 64 x 1024 rows; 18
# launches a rank step, with the input dropout's 21); and both FFN masks of
# the vslt stream on one device, the shape of earlier rows of PERF.md
MASK_SHAPES = {"input_vslt": (BATCH * 1020, 0, 256, 0),
               "input_txt": (BATCH * 129, 0, 256, 0),
               "input_img": (BATCH * 50, 0, 256, 0),
               "tp_ffn": (BATCH * 1024, 512, 256, 512),
               "ffn_whole": (BATCH * 1024, 1024, 256, 0)}


def check_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    code = _build.sass()
    for kernel in TENSOR_CORE_KERNELS:
        found = {n: c.count("HMMA") + c.count("HGMMA")
                 for n, c in code.items() if kernel in n}
        print(f"sass {kernel}: tensor-core instructions per instantiation "
              f"{sorted(found.values())}")
        if not found or not all(found.values()):
            raise AssertionError(f"{kernel}: no tensor-core instructions in "
                                 "its SASS")
    for kernel in WGMMA_KERNELS:
        found = {n: (c.count("HGMMA"), c.count("UTMALDG"))
                 for n, c in code.items() if kernel in n}
        print(f"sass {kernel}: (HGMMA, UTMALDG) per instantiation "
              f"{sorted(found.values())}")
        if not found or not all(h and t for h, t in found.values()):
            raise AssertionError(f"{kernel}: no HGMMA or no UTMALDG in its "
                                 "SASS")


def _median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _dev_us(e) -> float:
    """A profiler event's own device time (us)."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def _is_kernel(name: str, kernel: str) -> bool:
    """Whether the profiler key ``name`` is the port's kernel ``kernel``
    (any instantiation)."""
    return f"mtp::{kernel}<" in name or f"mtp::{kernel}(" in name


def _device_ms(fn, reps: int = 10, sessions: int = 20, expect=()):
    """torch.profiler over ``reps`` calls of ``fn`` after a warm-up: the
    device time of what they launched (kernels, copies) per call, and the
    names of the kernels. Beside the CUDA-event time around a call, it
    shows how much of that is the host's. On the card's machine the
    profiler can miss device records, the calls having run (the first
    launch after it starts, or now and then more): so each session runs
    the calls twice, a warm-up cycle whose records are dropped and the
    cycle it reads, and it counts only if every device event appears a
    whole number of times per call and each kernel named in ``expect``
    appears; else it is taken again, up to ``sessions`` times, and then
    this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # device records only; the schedule's step annotation spans them
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
                  and not e.key.startswith("ProfilerStep")]
        counts = {e.key: e.count for e in events}
        missing = [k for k in expect
                   if not any(_is_kernel(n, k) for n in counts)]
        if events and not missing and all(c % reps == 0
                                          for c in counts.values()):
            return (sum(_dev_us(e) for e in events) / reps / 1e3,
                    sorted(counts))
        print(f"profiler session of {reps} calls dropped records: counts "
              f"{counts}, missing {missing}; taken again")
    raise AssertionError(f"{sessions} profiler sessions dropped records")


def _bound(nbytes: float, flops: float, dt) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak for their type, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _compare(name, dt, call, work, live=None, library=None, plain=None,
             rate=None):
    """Run ``call`` through the kernel and ``plain`` (by default ``call``)
    through the plain version, check the tolerance on live rows, time both
    (and ``library``, one PyTorch call of the same function, where there is
    one). ``work``: (bytes, operations) the function needs on these
    inputs; ``rate``: the PEAK_FLOPS key of those operations (default
    ``dt``)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    plain = plain or call
    out = call()
    with ops.reference_path():
        ref = plain()
    torch.cuda.synchronize()
    if live is not None:
        out, ref = out[live], ref[live]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    atol, rtol = TOL[dt]
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = float(err.max())
    ms = _median_ms(call)
    with ops.reference_path():
        plain_ms = _median_ms(plain)
    library_ms = None if library is None else _median_ms(library)
    res = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           **_bound(*work, rate or dt), "library_ms": library_ms}
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    lib = "" if library_ms is None else f" library_ms={library_ms:.3f}"
    print(f"kernel {name} {tag}: max_abs_err={max_err:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}, {bad} outside) "
          f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}){lib}")
    if not np.isfinite(max_err) or bad:
        raise AssertionError(f"{name} {tag} disagrees with its plain version")
    return res


def compare_kernels() -> dict:
    """Each kernel against its plain version at the eval steps' shapes. Returns
    the bf16 result at each kernel's main-path shape named in its entry."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_attention import (
        cuda_window_attention, swin_attention_route)
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import (
        cuda_swin_mlp, swin_mlp_route)
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    from medical_tri_modal_pilot_tpu_torch.models.swin import _shift_attn_mask
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results = {}
    D = 256
    with torch.inference_mode():
        # umse: [64, 1000, 3] (time, value, feature id)
        x = torch.stack([
            -24 * torch.rand(BATCH, TIE_LEN, generator=g),
            torch.rand(BATCH, TIE_LEN, generator=g),
            torch.randint(0, 18, (BATCH, TIE_LEN), generator=g).float()],
            dim=-1).to(dev)
        stems = [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
                 rnd(D, std=.1)]
        stems += [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
                  rnd(D, std=.1)]
        table = rnd(20, D)
        tokens = BATCH * TIE_LEN
        for dt in (torch.float32, bf16):
            # per token: two affine + LayerNorm + relu stems (about 10
            # operations per element each, on the CUDA cores), the table
            # row and the sum
            work = (_nbytes(x, table, *stems) + tokens * D * (2 if dt == bf16
                                                              else 4),
                    22 * tokens * D)
            r = _compare("umse[64,1000,3]", dt,
                         lambda: ops.umse(x, *stems, table, dt), work,
                         rate=torch.float32)
        dev_ms, names = _device_ms(lambda: ops.umse(x, *stems, table, bf16))
        print(f"device umse[64,1000,3] bf16: {dev_ms:.4f} ms per call "
              f"(profiler; {names})")
        if not names or not all("umse_fwd_kernel" in n for n in names):
            raise AssertionError(f"umse launched {names}")
        results["umse"] = dict(r, shape="[64,1000,3]", device_ms=dev_ms)

        # attn_block and ffn at each stream's length: vslt 1024 and txt 133
        # with random lengths (sample 3 with every key masked); the single
        # image (config 4) 54, unmasked; three image slots (config 5) 152
        H = 4
        for L in STREAM_LENGTHS:
            if L == 54:
                mask = None
                ends = torch.full((BATCH,), L, device=dev)
                live = None
            else:
                lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
                lengths[3] = 0
                mask = length_key_mask(lengths.to(dev), L)
                ends = key_ends(mask).long()
                live = torch.arange(L, device=dev)[None, :] < ends[:, None]
            gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
            w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
            n = ends.double()
            # StdLN + q|k|v projection of the rows up to each sample's
            # last valid key, and the two attention products over them
            flops = float((6 * n * D * D + 4 * n * n * D).sum())
            for dt in (torch.float32, bf16):
                xa = rnd(BATCH, L, D).to(dt)
                wd, bd = w.to(dt), b.to(dt)
                call = lambda: ops.attn_block(xa, gamma, beta, wd, bd, mask,
                                              (D // H) ** .5, H)
                work = (2 * _nbytes(xa) + _nbytes(wd, bd, gamma, beta, mask),
                        flops)
                r = _compare(f"attn_block[64,{L},256]", dt, call, work, live)
                if L == 1024:
                    results["attn_block"] = dict(r, shape="[64,1024,256]")

            # ffn: C = 256, F = 1024 over the stream's 64*L rows; tile
            # flags where the rows align to whole tiles (vslt), else every
            # tile runs
            F = 4 * D
            gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
            w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
            w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
            for dt in (torch.float32, bf16):
                xf = rnd(BATCH, L, D).to(dt)
                flags = ffn_row_blocks(xf, mask)
                live = None if flags is None else flags.repeat_interleave(
                    L // flags.shape[1], dim=1)
                n_live = BATCH * L if live is None else float(live.sum())
                call = lambda: ops.ffn(xf, gamma, beta, w1, b1, w2, b2, flags)
                # the two products of the rows in live tiles
                wbytes = (D * F * 2 + F + D) * (2 if dt == bf16 else 4)
                work = (2 * _nbytes(xf) + wbytes + _nbytes(gamma, beta, flags),
                        4.0 * n_live * D * F)
                r = _compare(f"ffn[{BATCH * L},256]", dt, call, work, live)
                if live is not None:
                    skipped = ops.ffn(xf, gamma, beta, w1, b1, w2, b2,
                                      flags)[~live]
                    if not torch.equal(skipped, xf[~live]):
                        raise AssertionError("ffn: a skipped tile is not the "
                                             "residual")
                if L == 1024 and dt == bf16:
                    # the training forward's kernel alone (no autograd)
                    drop = _compare(
                        f"ffn[{BATCH * L},256] dropout 0.1 forward", dt,
                        lambda: ops.ffn(xf, gamma, beta, w1, b1, w2, b2,
                                        flags, p=0.1, training=True,
                                        seed=DROPOUT_SEED), work, live)
            if L == 1024:
                results["ffn"] = dict(r, shape="[65536,256]",
                                      dropout_ms=drop["ms"],
                                      dropout_plain_ms=drop["plain_ms"])

        # swin_attention and swin_mlp at Swin-T's four stages over the trunk
        # rows of each branch; window attention with and without the shift
        # mask where the stage has shifted blocks. At the main path's rows,
        # bf16: the library call beside the kernel at every stage and mask
        # (stage 1 also through the three-launch tensor-core route)
        trunk, mlp_stages = [], []
        for stage, (side, C, M, has_shift) in enumerate(SWIN_STAGES):
            nh = C // 32
            wqkv, bqkv = rnd(C, 3 * C, std=C ** -.5), rnd(3 * C, std=.1)
            wproj, bproj = rnd(C, C, std=C ** -.5), rnd(C, std=.1)
            bias = rnd(nh, 49, 49, std=.5)
            ln_s, ln_b = rnd(C, std=.1, mean=1.), rnd(C, std=.1)
            m1, c1 = rnd(C, 4 * C, std=C ** -.5), rnd(4 * C, std=.1)
            m2, c2 = rnd(4 * C, C, std=(4 * C) ** -.5), rnd(C, std=.1)
            masks = [None]
            if has_shift:
                masks.append(torch.from_numpy(
                    _shift_attn_mask(side, side, 7, 3)).to(dev))
            for rows in TRUNK_ROWS:
                I = rows * M
                T = I * 49
                for smask in masks:
                    for dt in (torch.float32, bf16):
                        xw = rnd(I, 49, C).to(dt)
                        ws = [t.to(dt) for t in (wqkv, bqkv, wproj, bproj)]
                        call = lambda: ops.swin_attention(xw, *ws, bias,
                                                          smask, nh)
                        work = (2 * _nbytes(xw) + _nbytes(*ws, bias, smask),
                                8.0 * T * C * C + 4.0 * T * 49 * C)
                        timed = rows == TRUNK_ROWS[0] and dt == bf16
                        library = (_mha_library_call(xw, ws, bias, smask, nh)
                                   if timed else None)
                        tag = (f"[{I},49,{C}]"
                               f"{'+mask' if smask is not None else ''}")
                        r = _compare(f"swin_attention{tag}", dt, call, work,
                                     library=library)
                        if not timed:
                            continue
                        route = swin_attention_route(dt, C)
                        kind = "none" if smask is None else "mask"
                        entry = dict(r, shape=tag, route=route,
                                     launches_per_step=SWIN_STAGE_LAUNCHES[
                                         stage][kind])
                        if route == "fused":
                            split = _compare(
                                f"swin_attention{tag} split route", dt,
                                lambda: cuda_window_attention(
                                    xw, *ws, bias, smask, nh, route="split"),
                                work, plain=call)
                            entry["split_ms"] = split["ms"]
                        trunk.append(entry)
                        if side == 56 and smask is not None:
                            results["swin_attention"] = dict(r, shape=tag)
                R = rows * side * side
                for dt in (torch.float32, bf16):
                    xm = rnd(R, C).to(dt)
                    wm = [m1.to(dt), m2.to(dt)]
                    work = (2 * _nbytes(xm) + _nbytes(*wm, ln_s, ln_b, c1, c2),
                            16.0 * R * C * C)
                    call = lambda: ops.swin_mlp(xm, ln_s, ln_b, wm[0], c1,
                                                wm[1], c2)
                    route = swin_mlp_route(dt, C)
                    r = _compare(f"swin_mlp[{R},{C}] {route}", dt, call,
                                 work)
                    if rows != TRUNK_ROWS[0]:
                        continue
                    entry = dict(r, shape=f"[{R},{C}]", form=route,
                                 launches_per_step=SWIN_MLP_LAUNCHES[stage])
                    if route.endswith("fused"):
                        # the dtype's split form at a width its route runs
                        # fused: the reading that keeps both forms
                        split = lambda: cuda_swin_mlp(xm, ln_s, ln_b, wm[0],
                                                      c1, wm[1], c2,
                                                      split=True)
                        entry["split_ms"] = _compare(
                            f"swin_mlp[{R},{C}] split route", dt, split,
                            work, plain=call)["ms"]
                    if dt == bf16:
                        mlp_stages.append(entry)
                        if side == 56:
                            results["swin_mlp"] = dict(r, shape=f"[{R},{C}]")
    totals = {k: sum(e["launches_per_step"] * e[k] for e in trunk)
              for k in ("ms", "library_ms", "bound_ms")}
    print(f"swin_attention bf16 over a config-4 step's trunk ({TRUNK_ROWS[0]}"
          f" rows; launches per stage 2/2/6/2): kernel {totals['ms']:.3f} ms, "
          f"F.multi_head_attention_forward {totals['library_ms']:.3f} ms, "
          f"bound {totals['bound_ms']:.4f} ms")
    results["swin_attention"].update(stages=trunk, trunk_totals=totals)
    totals = {k: sum(e["launches_per_step"] * e[k] for e in mlp_stages)
              for k in ("ms", "plain_ms", "bound_ms")}
    print(f"swin_mlp bf16 over a config-4 step's trunk ({TRUNK_ROWS[0]} rows;"
          f" launches per stage 2/2/6/2): kernel {totals['ms']:.3f} ms, "
          f"plain {totals['plain_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.4f} ms")
    results["swin_mlp"] = dict(results["swin_mlp"], stages=mlp_stages,
                               trunk_totals=totals)
    return results


def _grad_errors(grads, ref_grads):
    """Per tensor: |g - r|_F / |r|_F, the norms in float64 (a gradient can
    be far beyond fp32's range once squared: the cross transformer's
    txt_embedding.bias reaches about 4e21 on both paths, each txt self
    layer's StdLN backward multiplying the cotangent of the all-zero
    padded rows by 1 / (0 + 1e-6))."""
    return [float((g.double() - r.double()).norm())
            / max(float(r.double().norm()), 1e-30)
            for g, r in zip(grads, ref_grads)]


def _max_errors(grads, ref_grads):
    """Per tensor: the largest difference over the largest plain entry."""
    return [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for g, r in zip(grads, ref_grads)]


def _compare_train(name, dt, fwd, inputs, cot, live, work_fwd, work_bwd,
                   library=None):
    """The training forward and the backward of ``fwd`` on the kernel path
    against the plain path: the output on live rows (TOL), every gradient
    (GRAD_TOL); median ms of forward and backward on both paths, and of
    ``library`` (a forward and a backward call of PyTorch's own, where
    there are such). ``fwd`` may return a tuple (``cot`` is then one),
    timed as it is returned."""
    from medical_tri_modal_pilot_tpu_torch import ops
    runs = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        ctx = ops.reference_path() if plain else contextlib.nullcontext()
        with ctx:
            out = fwd(*leaves)
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            f_ms = _median_ms(lambda: fwd(*leaves), reps=10)
            b_ms = _median_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True), reps=10)
        # outputs that come apart (rowmm_ln's q, k, v) are joined for the
        # comparison only, after the timing
        if isinstance(out, tuple):
            out = torch.cat(out, -1)
        runs.append((out.detach().float(), [g.float() for g in grads],
                     f_ms, b_ms))
        del out, grads, leaves
    (out, grads, f_ms, b_ms), (ref, ref_grads, pf_ms, pb_ms) = runs
    torch.cuda.synchronize()
    if live is not None:
        out, ref = out[live], ref[live]
    err = (out - ref).abs()
    atol, rtol = TOL[dt]
    bad = int((err > atol + rtol * ref.abs()).sum())
    g_err = _grad_errors(grads, ref_grads)
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    lib_f, lib_b = ((None, None) if library is None
                    else (_median_ms(library[0]), _median_ms(library[1])))
    fwd_res = {"max_abs_err": float(err.max()), "ms": f_ms,
               "plain_ms": pf_ms, **_bound(*work_fwd, dt),
               "library_ms": lib_f}
    bwd_res = {"max_abs_err": max(float((g - r).abs().max())
                                  for g, r in zip(grads, ref_grads)),
               "grad_err_f": max(g_err), "ms": b_ms, "plain_ms": pb_ms,
               **_bound(*work_bwd, dt), "library_ms": lib_b}
    lib = ("" if library is None else
           f" library_ms={lib_f:.3f} / {lib_b:.3f} (forward / backward)")
    print(f"kernel {name} train fwd {tag}: max_abs_err="
          f"{fwd_res['max_abs_err']:.3e} ({bad} outside) ms={f_ms:.3f} "
          f"plain_ms={pf_ms:.3f} bound_ms={fwd_res['bound_ms']:.4f} "
          f"({fwd_res['bound_by']}){lib}")
    m_err = _max_errors(grads, ref_grads)
    print(f"kernel {name} bwd {tag}: grad |err|_F/|plain|_F "
          f"{' '.join(f'{e:.2e}' for e in g_err)} (tol {GRAD_TOL[dt]:g}); "
          f"max |err| / max |plain| {' '.join(f'{e:.2e}' for e in m_err)} "
          f"ms={b_ms:.3f} plain_ms={pb_ms:.3f} "
          f"bound_ms={bwd_res['bound_ms']:.4f} ({bwd_res['bound_by']})")
    if bad or not np.isfinite(fwd_res["max_abs_err"]):
        raise AssertionError(f"{name} {tag}: training forward disagrees")
    if not all(np.isfinite(e) and e <= GRAD_TOL[dt] for e in g_err):
        raise AssertionError(f"{name} {tag}: gradients disagree")
    return fwd_res, bwd_res


def _bwd_repeats(fwd, inputs, cot) -> bool:
    """The kernel path's gradients of ``fwd`` twice from one graph: raises
    unless they are the same bit for bit (no float atomics)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fwd(*leaves)
    first = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    again = torch.autograd.grad(out, leaves, cot)
    same = all(torch.equal(a, e) for a, e in zip(first, again))
    print(f"backward bit-identical over two runs: {same}")
    if not same:
        raise AssertionError("the backward differs between runs")
    return same


def _ffn_bwd_parts(x, ws, flags, cot, n_live) -> dict:
    """The ffn backward's two parts timed apart (CUDA events): the tile
    pass and the weight sums; the sums must repeat bit for bit."""
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
        ffn_bwd_tiles, ffn_weight_sums)
    P = 0.1
    tiles = lambda: ffn_bwd_tiles(x, *ws, flags, P, DROPOUT_SEED, cot)
    _, ln, dz, hd, dh, _, valid = tiles()
    sums = lambda: ffn_weight_sums(ln, dz, hd, dh, valid)
    first, again = sums(), sums()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    res = {"tiles_ms": _median_ms(tiles), "sums_ms": _median_ms(sums),
           "live_rows": n_live / x[..., 0].numel(),
           "sums_bit_identical": same}
    print(f"ffn_bwd bf16 [{x[..., 0].numel()},{x.shape[-1]}] p {P}: live "
          f"rows {res['live_rows']:.4f}; tile pass {res['tiles_ms']:.3f} ms, "
          f"weight sums {res['sums_ms']:.3f} ms; weight sums bit-identical "
          f"over two runs: {same}")
    if not same:
        raise AssertionError("ffn_bwd: the weight sums differ between runs")
    return res


def _attn_block_work(L: int, D: int, H: int, es: int, n) -> tuple:
    """(bytes, operations) of the attention block's training forward and
    of its backward on [BATCH, L, D] with H heads, ``es`` bytes an
    element, ``n`` [BATCH] the rows up to each sample's last valid key.
    Forward: the lean form's work plus O and the (m, l) stats; backward:
    s, dp, dv, dk and dq over the live pairs (10 n^2 C) and the q|k|v
    recompute, dln and dW products (18 n C^2)."""
    stream_bytes = BATCH * L * D * es
    return ((3 * stream_bytes + 8 * BATCH * H * L + (3 * D * D + 3 * D) * es,
             float((6 * n * D * D + 4 * n * n * D).sum())),
            (4 * stream_bytes + 8 * BATCH * H * L
             + (3 * D * D + 3 * D) * (es + 4),
             float((10 * n * n * D + 18 * n * D * D).sum())))


def compare_training_kernels() -> dict:
    """The training kernels against autograd of their plain versions at each
    fusion stream's length. Returns the bf16 results at the main-path
    shapes (vslt: [64, 1024, 256], R = 65536)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    bf16 = torch.bfloat16
    D, H, F, P = 256, 4, 1024, 0.1

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results = {}
    for L in STREAM_LENGTHS:
        if L == 54:
            mask, ends = None, torch.full((BATCH,), L, device=dev)
        else:
            lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
            lengths[3] = 0
            mask = length_key_mask(lengths.to(dev), L)
            ends = key_ends(mask).long()
        live = torch.arange(L, device=dev)[None, :] < ends[:, None]
        n = ends.double()
        gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
        w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xa = rnd(BATCH, L, D).to(dt)
            cot = rnd(BATCH, L, D).to(dt) * live[:, :, None]
            work_f, work_b = _attn_block_work(L, D, H, es, n)
            fr, br = _compare_train(
                f"attn_block[64,{L},256]", dt,
                lambda *a: ops.attn_block(*a, mask, (D // H) ** .5, H),
                (xa, gamma, beta, w.to(dt), b.to(dt)), cot, live, work_f,
                work_b)
            if L == 1024 and dt == bf16:
                results["attn_block_train"] = dict(fr, shape="[64,1024,256]")
                results["attn_block_bwd"] = dict(
                    br, shape="[64,1024,256]", bit_identical=_bwd_repeats(
                        lambda *a: ops.attn_block(*a, mask, (D // H) ** .5,
                                                  H),
                        (xa, gamma, beta, w.to(dt), b.to(dt)), cot))

        g1, be1 = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
        w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
        w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xf = rnd(BATCH, L, D).to(dt)
            flags = ffn_row_blocks(xf, mask)
            rows = (None if flags is None else
                    flags.repeat_interleave(L // flags.shape[1], dim=1))
            n_live = BATCH * L if rows is None else float(rows.sum())
            cot = rnd(BATCH, L, D).to(dt)
            if rows is not None:
                cot = cot * rows[:, :, None]
            wbytes = (2 * D * F + F + D) * 4
            work_f = (2 * BATCH * L * D * es + wbytes, 4.0 * n_live * D * F)
            # h recompute, dh, dln, dW1 and dW2: five products
            work_b = (3 * BATCH * L * D * es + 2 * wbytes,
                      10.0 * n_live * D * F)
            fr, br = _compare_train(
                f"ffn[{BATCH * L},256] dropout {P}", dt,
                lambda *a: ops.ffn(*a, flags, p=P, training=True,
                                   seed=DROPOUT_SEED),
                (xf, g1, be1, w1, b1, w2, b2), cot, rows, work_f, work_b)
            if L == 1024 and dt == bf16:
                results["ffn_train"] = dict(fr, shape="[65536,256]")
                results["ffn_bwd"] = dict(
                    br, shape="[65536,256]",
                    **_ffn_bwd_parts(xf, (g1, be1, w1, b1, w2), flags, cot,
                                     n_live))

    return results


def compare_dropout_masks() -> dict:
    """dropout_masks at MASK_SHAPES: both masks bit for bit against the
    plain version, keep rates within 5 sd of q, CUDA-event ms (host work
    included) and the profiler's device ms per call beside the plain
    version's ms and the bound; the calls must launch dropout_masks_kernel
    alone. Returns the main path's vslt input shape as the kernel's entry,
    every shape under "shapes"."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import keep_threshold
    dev = torch.device("cuda")
    P = 0.1
    shapes = {}
    for key, (R, F, C, col0) in MASK_SHAPES.items():
        call = lambda: ops.dropout_masks(R, F, C, DROPOUT_SEED, P, dev,
                                         col0=col0)
        with torch.inference_mode():
            got = call()
            with ops.reference_path():
                want = call()
            torch.cuda.synchronize()
            same = all(a.dtype == torch.bool and torch.equal(a, e)
                       for a, e in zip(got, want))
            keep = [float(k.float().mean()) for k in got if k.numel()]
            sds = [((1 - P) * P / k.numel()) ** .5 for k in got if k.numel()]
            del got, want
            ms = _median_ms(call)
            dev_ms, names = _device_ms(call)
            with ops.reference_path():
                plain_ms = _median_ms(call, reps=3)
        nbytes = R * (F + C)
        res = {"max_abs_err": 0.0 if same else 1.0, "ms": ms,
               "device_ms": dev_ms, "plain_ms": plain_ms,
               **_bound(nbytes, PHILOX_OPS_PER_BYTE * nbytes, torch.int32),
               "library_ms": None, "shape": f"[{R},{F}]+[{R},{C}]",
               "col0": col0, "keep_rate": keep,
               "threshold": keep_threshold(P)}
        print(f"kernel dropout_masks {key} [{R},{F}]+[{R},{C}] col0 {col0} "
              f"p={P}: bit-identical {same}; keep rate "
              f"{' / '.join(f'{k:.6f}' for k in keep)} (q {1 - P}, sd "
              f"{' / '.join(f'{sd:.2e}' for sd in sds)}) ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}); "
              f"launched {names}")
        if not same:
            raise AssertionError(f"dropout_masks {key} differs from its "
                                 "plain version")
        if any(abs(k - (1 - P)) > 5 * sd for k, sd in zip(keep, sds)):
            raise AssertionError(f"dropout_masks {key}: keep rate {keep} "
                                 f"outside 5 sd of {1 - P}")
        if not names or not all("dropout_masks_kernel" in n for n in names):
            raise AssertionError(f"dropout_masks {key} launched {names}")
        shapes[key] = res
    return {"dropout_masks": dict(shapes["input_vslt"], shapes=shapes)}


def _umse_case(g, dev):
    """Seeded umse inputs at the main path's shape: x [64, 1000, 3] with
    the TIE stream's feature ids (0-17) and two ids past the table's end,
    the eight stem vectors and the [20, 256] table."""
    D = 256

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    x = torch.stack([
        -24 * torch.rand(BATCH, TIE_LEN, generator=g),
        torch.rand(BATCH, TIE_LEN, generator=g),
        torch.randint(0, 18, (BATCH, TIE_LEN), generator=g).float()], dim=-1)
    x[0, 0, 2], x[-1, -1, 2] = 20, 23
    params = []
    for _ in range(2):
        params += [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
                   rnd(D, std=.1)]
    return x.to(dev), params + [rnd(20, D)]


def compare_umse_bwd() -> dict:
    """The umse backward kernel against torch_umse_bwd, its closed form in
    plain torch rounded where the kernel rounds, at the main path's shape
    ([64, 1000, 3] -> [64, 1000, 256]): fp32 per tensor by Frobenius ratio
    within 1e-2; bf16 held against the fp32 closed form, within
    STEP_BF16_RATIO of the bf16 closed form's distance from it plus 1e-2
    (the rule of PERF.md §2); bit for bit the same over two runs. CUDA-event
    ms of the kernel, of the closed form and of the autograd recompute of
    torch_umse it replaces (the parent's backward), and the profiler's
    device ms and launched kernels of the kernel and of that recompute."""
    from medical_tri_modal_pilot_tpu_torch.kernels.umse import (
        cuda_umse_bwd, torch_umse, torch_umse_bwd)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    x, params = _umse_case(g, dev)
    D, bf16 = 256, torch.bfloat16
    dout = {torch.float32: torch.randn(BATCH, TIE_LEN, D, generator=g)
            .to(dev)}
    dout[bf16] = dout[torch.float32].to(bf16)
    f32_err = _grad_errors(
        cuda_umse_bwd(x, *params, dout[torch.float32], torch.float32),
        torch_umse_bwd(x, *params, dout[torch.float32], torch.float32))
    ref32 = torch_umse_bwd(x, *params, dout[bf16].float(), torch.float32)
    got = cuda_umse_bwd(x, *params, dout[bf16], bf16)
    plain = torch_umse_bwd(x, *params, dout[bf16], bf16)
    bf_err, plain_err = _grad_errors(got, ref32), _grad_errors(plain, ref32)
    max_err = max(float((a - e).abs().max()) for a, e in zip(got, plain))
    del got, plain, ref32
    same = all(torch.equal(a, e) for a, e in zip(
        cuda_umse_bwd(x, *params, dout[bf16], bf16),
        cuda_umse_bwd(x, *params, dout[bf16], bf16)))
    kernel = lambda: cuda_umse_bwd(x, *params, dout[bf16], bf16)
    closed = lambda: torch_umse_bwd(x, *params, dout[bf16], bf16)
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    recompute = lambda: torch.autograd.grad(
        torch_umse(x, *leaves, bf16), leaves, dout[bf16])
    ms, plain_ms, re_ms = (_median_ms(kernel), _median_ms(closed),
                           _median_ms(recompute))
    dev_ms, names = _device_ms(kernel)
    items, re_dev, _ = _step_split(lambda _: recompute(), None)
    re_launches = sum(n for _, n, _ in items)
    R = BATCH * TIE_LEN
    # read dout and x once, the stem vectors and the table; write the
    # [28, 256] gradients. Per element and stem about 8 operations to
    # recompute the stem and 13 for its backward, on the CUDA cores
    nbytes = R * D * 2 + R * 12 + 2 * (8 + 20) * D * 4
    res = {"max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, **_bound(nbytes, 42 * R * D,
                                          torch.float32),
           "library_ms": None, "shape": "[64,1000,256]",
           "grad_err_f": max(bf_err), "bit_identical": same,
           "recompute_ms": re_ms, "recompute_device_ms": re_dev,
           "recompute_launches": re_launches}
    fmt = lambda es: " ".join(f"{e:.2e}" for e in es)
    print(f"kernel umse_bwd [64,1000,256] fp32: |err|_F/|plain|_F "
          f"{fmt(f32_err)} (tol 1e-2)")
    print(f"kernel umse_bwd [64,1000,256] bf16: |err|_F/|fp32|_F "
          f"{fmt(bf_err)}, the bf16 closed form's {fmt(plain_err)} (tol "
          f"{STEP_BF16_RATIO}x + 1e-2); max |err| against the bf16 closed "
          f"form {max_err:.3e}; bit-identical "
          f"over two runs: {same}; ms={ms:.4f} device_ms={dev_ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={res['bound_ms']:.4f} "
          f"({res['bound_by']}); launched {names}")
    print(f"umse backward as autograd of torch_umse (the recompute it "
          f"replaces), bf16: {re_ms:.3f} ms by events, device {re_dev:.4f} "
          f"ms in {re_launches} launches")
    if not all(np.isfinite(e) and e <= 1e-2 for e in f32_err):
        raise AssertionError("umse_bwd fp32 disagrees with torch_umse_bwd")
    if not all(np.isfinite(k) and k <= STEP_BF16_RATIO * p + 1e-2
               for k, p in zip(bf_err, plain_err)):
        raise AssertionError("umse_bwd bf16 strays from the fp32 closed form")
    if not same:
        raise AssertionError("umse_bwd differs between runs")
    want = ("umse_bwd_kernel", "col_sum_kernel")
    if sorted({k for n in names for k in want if k in n}) != sorted(want) \
            or not all(any(k in n for k in want) for n in names):
        raise AssertionError(f"umse_bwd launched {names}")
    return {"umse_bwd": res}


# the cross-modal layers' attention, 4 heads of 64 over batch 64: (name,
# Lq, Lk, key mask) with the mask of the kv stream: cross_v's vslt queries
# against the txt stream (clip(txt_length + 2, 1, 128) valid keys),
# cross_o's txt queries against the vslt stream (input_length in [1, 24])
CROSS_SHAPES = (("cross_v", 24, 128, "txt"), ("cross_o", 128, 24, "vslt"))
# the tensor-parallel self-attention of config 4, one rank's 2 of 4 heads
# over each fusion stream: (name, L, mask) for the TIE stream's 1024 rows
# (key mask at input_length + 1 cls + 4 bottlenecks), the notes' 133 (key
# mask at the note length + 1 cls + 4 bottlenecks) and the image's 54 (no
# mask)
TP_SELF = (("tp_self", 1024, "tie"), ("tp_txt", 133, "txt_self"),
           ("tp_img", 54, "img_self"))
# phase 22's forms at one rank's 2 of 4 heads: the cross transformer's
# cross layers under --mp-size 2 (both directions, as CROSS_SHAPES), and
# tri_mbt_vmulti's vslt stream under its 3-D block mask (4 cls + 1000 TIE
# rows + 12 bottlenecks; models/mbt.py::block_key_mask over seeded
# lengths, every row compared)
TP_CROSS = (("tp_cross_v", 24, 128, "txt"), ("tp_cross_o", 128, 24, "vslt"))
TP_BLOCK = (("tp_block", 4 + TIE_LEN + 12, "block_vslt"),)
# small shapes: (B, H, Lq, Lk, d_head, mask form), the tile loop's edges
# (Lq < 16, Lk < 16) last
ATTN_SMALL = ((3, 2, 54, 54, 32, "none"), (3, 2, 130, 130, 32, "noncontig"),
              (3, 2, 40, 100, 32, "all_masked"),
              (2, 2, 130, 70, 32, "block"), (3, 2, 300, 300, 64, "self"),
              (3, 2, 5, 300, 32, "noncontig"), (3, 2, 130, 7, 32, "block"))


def _attention_case(g, dev, B, H, Lq, Lk, D, kind):
    """fp32 q, k, v, the mask, is_self and the live rows [B, Lq] (under
    is_self, the rows before each sample's last valid key)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.models.modules import \
        length_key_mask

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    q, k, v = rnd(B, Lq, H, D), rnd(B, Lk, H, D), rnd(B, Lk, H, D)
    lengths = {
        "txt": (torch.randint(0, 129, (B,), generator=g) + 2).clamp(1, Lk),
        "vslt": torch.randint(1, Lk + 1, (B,), generator=g),
        "tie": torch.randint(5, TIE_LEN + 1, (B,), generator=g) + 5,
        "self": torch.tensor([10, 150, Lk]),
        "all_masked": torch.linspace(0, Lk, B).long(),
        # the image tokens of the legacy cross transformer: all valid
        "img": torch.full((B,), Lk)}.get(kind)
    if kind == "block_vslt":
        # the rows of the multitoken vslt stream: cls + TIE rows + 12
        return (q, k, v, _stream_block_mask(g, dev, 0, Lk - 16, False), True,
                torch.ones(B, Lq, dtype=torch.bool, device=dev))
    if kind == "txt_self":
        # 4 bottleneck keys, then cls and the notes; samples 0 and 3
        # without notes: the bottleneck keys alone
        lengths = torch.randint(5, Lk + 1, (B,), generator=g)
        lengths[:4] = torch.tensor([4, 40, Lk, 4])
    mask = None
    if lengths is not None:
        mask = length_key_mask(lengths.to(dev), Lk)
    elif kind == "noncontig":
        mask = torch.rand(B, Lk, generator=g).to(dev) < 0.5
    elif kind == "block":
        mask = torch.rand(B, Lq, Lk, generator=g).to(dev) < 0.5
        mask[:, :, 0] = False
        mask[0, 3] = True   # a query whose every key is masked
    live = torch.ones(B, Lq, dtype=torch.bool, device=dev)
    is_self = kind in ("self", "tie", "txt_self", "img_self")
    if is_self and mask is not None:
        live = torch.arange(Lq, device=dev)[None] < key_ends(mask)[:, None]
    return q, k, v, mask, is_self, live


def _attention_work(q, k, mask, is_self, backward=False):
    """(bytes, operations) of the attention on these inputs: q, k, v, the
    mask and the output once (the backward: q, k, v, out, dout, the stats
    and the mask read, dq, dk, dv written); the products over the (query,
    key) pairs the data needs: with a key mask, the keys up to each
    sample's last valid one and, under is_self, the queries before it. Two
    products forward (s and p v), five backward (s, dp, dv, dk, dq)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    nq = torch.full((B,), float(Lq), dtype=torch.float64)
    nk = torch.full((B,), float(Lk), dtype=torch.float64)
    if mask is not None and mask.dim() == 2:
        nk = key_ends(mask).double().cpu()
        if is_self:
            nq = nk
    pairs = float((nq * nk).sum())
    if mask is not None and mask.dim() == 3:
        # a block mask: each query's unmasked keys (every key where all are
        # masked: the row attends uniformly)
        n = (~mask).sum(-1)
        pairs = float(torch.where(n == 0, Lk, n).double().sum())
    stats = B * H * Lq * 8
    if backward:
        nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + stats + _nbytes(mask)
        return nbytes, 10.0 * H * D * pairs
    return 2 * _nbytes(q) + 2 * _nbytes(k) + _nbytes(mask), 4.0 * H * D * pairs


# the kernels each route of the masked attention launches (forward and
# backward; kernels/attention.py::attention_route picks the route)
ATTN_ROUTE_KERNELS = {
    "tc": (("attention_fwd_tc_kernel",),
           ("attention_delta_kernel", "attention_dkv_tc_kernel",
            "attention_dq_tc_kernel")),
    "fma": (("attention_fwd_kernel",),
            ("attention_dkv_kernel", "attention_dq_kernel"))}


def _device_forms(tag, dt, fwd, inputs, cot, library, routes, route
                  ) -> dict:
    """Profiler device ms per call of ``fwd``'s lean form, training form
    and backward (and of the library's forward and backward), to set
    beside the CUDA-event times around the calls: the rest is the host's.
    Raises unless the calls launched every kernel of ``route`` in
    ``routes`` (route -> (forward, backward) kernel names), each form its
    own, and none of another route's."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    fwd_kernels, bwd_kernels = routes[route]
    with torch.inference_mode():
        lean, names = _device_ms(lambda: fwd(*inputs), expect=fwd_kernels)
    train, more = _device_ms(lambda: fwd(*leaves), expect=fwd_kernels)
    names += more
    out = fwd(*leaves)
    bwd, more = _device_ms(lambda: torch.autograd.grad(
        out, leaves, cot, retain_graph=True), expect=bwd_kernels)
    launched = _launched_route(names + more, routes, route)
    lib = ((None, None) if library is None else
           (_device_ms(library[0])[0], _device_ms(library[1])[0]))
    prec = "bf16" if dt == torch.bfloat16 else "fp32"
    lib_txt = ("" if library is None else
               f"; library {lib[0]:.4f} / {lib[1]:.4f}")
    print(f"device {tag} {prec}: lean {lean:.4f} ms, training {train:.4f}, "
          f"backward {bwd:.4f}{lib_txt} (profiler); route {route}: "
          f"{' '.join(sorted(launched))}")
    return {"lean": lean, "train": train, "bwd": bwd, "library": lib,
            "names": names + more}


def compare_attention_kernels() -> dict:
    """The masked attention against its plain version: the lean form, the
    training form and the backward, fp32 and bf16, at the cross-modal
    layers' shapes and at the tensor-parallel self shapes of the three
    streams (with scaled_dot_product_attention on the same inputs as the
    library column), at phase 22's rank shapes (TP_CROSS, TP_BLOCK, with
    the library column) and at the small shapes of every mask form.
    Returns the bf16 results at cross_v's shape, at the TIE stream's TP
    shape (``attention_tp*``) and at tp_cross_v's and tp_block's
    (``attention_tp_cross*``, ``attention_tp_block*``)."""
    import torch.nn.functional as F
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
        attention_route
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [(name, BATCH, 4, Lq, Lk, 64, kind)
             for name, Lq, Lk, kind in CROSS_SHAPES]
    cases += [(name, BATCH, 2, L, L, 64, kind) for name, L, kind in TP_SELF]
    cases += [(name, BATCH, 2, Lq, Lk, 64, kind)
              for name, Lq, Lk, kind in TP_CROSS]
    cases += [(name, BATCH, 2, L, L, 64, kind) for name, L, kind in TP_BLOCK]
    cases += [(c[5], *c) for c in ATTN_SMALL]
    results = {}
    for name, B, H, Lq, Lk, D, kind in cases:
        q, k, v, mask, is_self, live = _attention_case(g, dev, B, H, Lq, Lk,
                                                       D, kind)
        tag = f"attention {name} q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            cot = torch.randn(B, Lq, H, D, generator=g).to(dev).to(dt)
            cot = cot * live[:, :, None, None]
            library = None
            if name.startswith(("cross", "tp_")):
                # [B, H, L, Dh] copies made before the timing; True = attend
                qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (qd, kd, vd))
                keep = (None if mask is None else ~mask[:, None, None, :]
                        if mask.dim() == 2 else ~mask[:, None])

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=keep)
                out_t, cot_t = sdpa(), cot.transpose(1, 2).contiguous()

                def sdpa_bwd():
                    return torch.autograd.grad(out_t, (qt, kt, vt), cot_t,
                                               retain_graph=True)
                library = (sdpa, sdpa_bwd)
            with torch.inference_mode():
                r = _compare(tag, dt, lambda: ops.attention(
                    qd, kd, vd, mask, D ** .5, is_self),
                    _attention_work(qd, kd, mask, is_self), live,
                    library=library and library[0])
            fr, br = _compare_train(
                tag, dt, lambda *a: ops.attention(*a, mask, D ** .5, is_self),
                (qd, kd, vd), cot, live,
                _attention_work(qd, kd, mask, is_self),
                _attention_work(qd, kd, mask, is_self, backward=True),
                library=library)
            dres = _device_forms(
                tag, dt, lambda *a: ops.attention(*a, mask, D ** .5, is_self),
                (qd, kd, vd), cot, library, ATTN_ROUTE_KERNELS,
                attention_route(dt, D))
            for res, form, i in ((r, "lean", 0), (fr, "train", 0),
                                 (br, "bwd", 1)):
                res["device_ms"] = dres[form]
                res["library_device_ms"] = dres["library"][i]
            shape = f"q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
            key = {"cross_v": "attention", "tp_self": "attention_tp",
                   "tp_cross_v": "attention_tp_cross",
                   "tp_block": "attention_tp_block"}.get(name)
            if key and dt == torch.bfloat16:
                results[key] = dict(r, shape=shape)
                results[f"{key}_train"] = dict(fr, shape=shape)
                results[key.replace("attention", "attention_bwd")] = dict(
                    br, shape=shape)
    return results


# the row-skipping projections: (result key, output width, LN-fused): one
# rank's q|k|v under --mp-size 2, the single-device q|k|v, and the plain
# form at the single-device width (no path reaches it)
ROWMM_SHAPES = (("rowmm_ln", 384, True), ("rowmm_ln_768", 768, True),
                ("rowmm", 768, False))
# the kernels of each rowmm route (kernels/rowmm.py rowmm_route)
ROWMM_ROUTE_KERNELS = {
    "tc": (("rowmm_tc_kernel",), ("rowmm_bwd_tc_kernel",)),
    "fma": (("rowmm_kernel",), ("rowmm_bwd_kernel",))}


def _launched_route(names, table, route) -> set:
    """The kernels of ``table`` (route -> (forward, backward) kernel names)
    that ``names`` (profiler keys) show launched; raises unless they are
    ``route``'s."""
    launched = {k for forms in table.values() for ks in forms for k in ks
                if any(_is_kernel(n, k) for n in names)}
    want = set(table[route][0] + table[route][1])
    if launched != want:
        raise AssertionError(f"launched {sorted(launched)}, not the {route} "
                             f"route's kernels {sorted(want)}")
    return launched


def _rowmm_case(g, dev, dt, cout, ln, live, flags):
    """Seeded inputs of one rowmm form over x [BATCH * 1024, 256]: (inputs,
    the call, the cotangent: zero on dead blocks, split as the outputs)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    L, D = 1024, 256

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    x = rnd(BATCH, L, D).to(dt)
    w, b = rnd(D, cout, std=D ** -.5).to(dt), rnd(cout, std=.1).to(dt)
    cot = rnd(BATCH, L, cout).to(dt) * live[:, :, None]
    if ln:
        inputs = (x, rnd(D, std=.1, mean=1.), rnd(D, std=.1), w, b)
        cot = tuple(c.contiguous() for c in cot.split(cout // 3, -1))
        return inputs, lambda *a: ops.rowskip_ln_affine(*a, flags), cot
    return (x, w, b), lambda *a: ops.rowskip_affine(*a, flags), cot


def compare_rowmm_kernels() -> dict:
    """rowmm_ln and rowmm, forward and backward, against autograd of their
    plain versions in fp32 and bf16 over x [64 * 1024, 256], the 256-row
    block flags of TIE lengths uniform in [5, 1000] (the fusion stream's
    key mask), the cotangent zero on dead blocks. The LN form is timed as
    it returns q, k and v (apart) and takes their cotangents apart.
    torch.addmm (and its autograd.grad) is the library column of the plain
    form; no PyTorch call computes the LN form. Then the profiler's device
    ms per call of each form, lean, training and backward (and of the
    library calls), and the kernels the calls launched, which must be the
    dtype's route's. Returns the bf16 results by kernel name."""
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import (
        BLOCK_R, rowmm_route)
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    L, D = 1024, 256
    lengths = torch.randint(5, TIE_LEN + 1, (BATCH,), generator=g) + 5
    mask = length_key_mask(lengths.to(dev), L)
    flags = ffn_row_blocks(mask[:, :, None], mask, BLOCK_R)
    live = flags.repeat_interleave(BLOCK_R, dim=1)
    n_live = float(live.sum())
    R = BATCH * L
    print(f"rowmm: {int(flags.sum())} of {flags.numel()} row blocks live "
          f"({n_live / R:.3f} of the rows)")
    results = {}
    for key, cout, ln in ROWMM_SHAPES:
        name = "rowmm_ln" if ln else "rowmm"
        for dt in (torch.float32, torch.bfloat16):
            es = 2 if dt == torch.bfloat16 else 4
            inputs, fwd, cot = _rowmm_case(g, dev, dt, cout, ln, live, flags)
            x, w, b = inputs[0], inputs[-2], inputs[-1]
            # x read on the live rows, every output row written once (dead
            # blocks as zeros); backward: x and dy read on the live rows, dx
            # written on every row, dW and db (and dgamma, dbeta) in fp32;
            # the products over the live rows (dx and dW backward)
            wbytes = (D * cout + cout) * es + (8 * D if ln else 0)
            work_f = ((n_live * D + R * cout) * es + wbytes,
                      2.0 * n_live * D * cout)
            work_b = ((n_live * (D + cout) + R * D) * es + wbytes
                      + (D * cout + cout + (2 * D if ln else 0)) * 4,
                      4.0 * n_live * D * cout)
            library = None
            if not ln:
                xl, wl, bl = (t.detach().clone().requires_grad_()
                              for t in (x.reshape(R, D), w, b))
                out_t = torch.addmm(bl, xl, wl)
                cot_t = cot.reshape(R, cout)
                library = (lambda: torch.addmm(b, x.reshape(R, D), w),
                           lambda: torch.autograd.grad(
                               out_t, (xl, wl, bl), cot_t, retain_graph=True))
            tag = f"{name}[{R},{D}]x[{D},{cout}]"
            fr, br = _compare_train(tag, dt, fwd, inputs, cot, live, work_f,
                                    work_b, library)
            dres = _device_forms(tag, dt, fwd, inputs, cot, library,
                                 ROWMM_ROUTE_KERNELS,
                                 rowmm_route(dt, inputs[0].shape[-1]))
            for res, form, i in ((fr, "train", 0), (br, "bwd", 1)):
                res["device_ms"] = dres[form]
                res["library_device_ms"] = dres["library"][i]
            del library
            if dt == torch.bfloat16:
                shape = f"[{R},{D}]x[{D},{cout}]"
                results[key] = dict(fr, shape=shape)
                results[key.replace(name, f"{name}_bwd")] = dict(br,
                                                                 shape=shape)
    return results


def _mha_library_args(xw, ws, bias, smask, nh):
    """(windows [N, I, C], w_in, b_in, w_out, b_out, the additive mask
    holding the bias and -65504 at shift-masked keys (``smask`` None: the
    bias alone)) of torch's multi_head_attention_forward on the windows,
    in xw's dtype."""
    I, N, C = xw.shape
    wqkv, bqkv, wproj, bproj = (t.to(xw.dtype) for t in ws)
    add = bias[None].expand(I, nh, N, N)
    if smask is not None:
        sm = smask.repeat(I // smask.shape[0], 1, 1)[:, None]
        add = add + torch.where(sm, -65504.0, 0.0)
    add = add.to(xw.dtype).reshape(I * nh, N, N).contiguous()
    return (xw.transpose(0, 1).contiguous(), wqkv.t().contiguous(), bqkv,
            wproj.t().contiguous(), bproj, add)


def _mha_forward(q, w_in, b_in, w_out, b_out, add, nh):
    import torch.nn.functional as F
    return F.multi_head_attention_forward(
        q, q, q, q.shape[-1], nh, w_in, b_in, None, None, False, 0.0, w_out,
        b_out, training=False, need_weights=False, attn_mask=add)[0]


def _mha_library_call(xw, ws, bias, smask, nh):
    """torch's multi_head_attention_forward on the same windows: the q|k|v
    projection, scores + the additive mask, softmax, @v, the output
    projection. A yardstick only; the port never calls it."""
    args = _mha_library_args(xw, ws, bias, smask, nh)
    return lambda: _mha_forward(*args, nh)


def _mha_library_grad(xw, ws, bias, smask, nh, cot):
    """(a forward call, a backward call) of that library function under
    autograd: the backward's gradients of the windows and the four
    weights for ``cot`` [I, N, C] (the bias rides in the additive mask,
    which takes none). A yardstick only."""
    *leaves, add = (t.detach().clone()
                    for t in _mha_library_args(xw, ws, bias, smask, nh))
    leaves = [t.requires_grad_() for t in leaves]
    out = _mha_forward(*leaves, add, nh)
    cot_t = cot.transpose(0, 1)
    return (lambda: _mha_forward(*leaves, add, nh),
            lambda: torch.autograd.grad(out, leaves, cot_t,
                                        retain_graph=True))


def _eval_steps(trainer, batches):
    probs, losses, rows = [], [], []
    for batch in batches:
        p, loss, _ = trainer.eval_step(batch)
        probs.append(p)
        losses.append(loss)
        rows.append(getattr(trainer.model, "trunk_rows", 0))
    return np.concatenate(probs), losses, rows


def _timed_ms(trainer, batches, reference: bool) -> float:
    from medical_tri_modal_pilot_tpu_torch import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if reference:
        with ops.reference_path():
            _eval_steps(trainer, batches)
    else:
        _eval_steps(trainer, batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def _step_split(step, batch):
    """torch.profiler over one step (after warm-up): its device events
    (us, count, name), largest first, their total (ms) and the step's host
    wall time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    # device events only (kernels, copies); the CPU ops that launched
    # them would count their time twice
    items = sorted(((_dev_us(e), e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and _dev_us(e) > 0),
                   reverse=True)
    return items, sum(t for t, _, _ in items) / 1e3, wall


def _profile_step(name, trainer, batch, power: str,
                  train: bool = False) -> list:
    """torch.profiler over one step (after warm-up): device time by kernel,
    the step's device total against its host wall time. Returns the
    device events (us, count, name)."""
    step = trainer.train_step if train else trainer.eval_step
    items, total, wall = _step_split(step, batch)
    kind = "train" if train else "eval"
    print(f"profile {name} bf16 {kind} step ({power}): device busy "
          f"{total:.2f} ms of {wall:.2f} ms host wall, device idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for t, count, key in items[:24 if train else 16]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / 1e3 / total:5.1f} % "
              f"x{count:<4d} {key[:90]}")
    return items


# the kernels of the TIE embedding and the input dropout in one config-4
# train step: the umse forward and its backward (a row pass, then col_sum,
# which the other backward kernels' weight sums launch too), and a mask
# launch per stream
STEP_KERNELS = {"umse_fwd_kernel": 1, "umse_bwd_kernel": 1,
                "dropout_masks_kernel": 3}


def _check_step_kernels(items) -> None:
    """The profiled step launched STEP_KERNELS as many times as they say:
    the umse backward ran as its kernel, not as a recompute."""
    got = {k: sum(n for _, n, key in items if f"mtp::{k}" in key)
           for k in STEP_KERNELS}
    ms = {k: sum(t for t, _, key in items if f"mtp::{k}" in key) / 1e3
          for k in STEP_KERNELS}
    print("profile config4 train step: " + ", ".join(
        f"{k} x{got[k]} {ms[k]:.4f} ms" for k in STEP_KERNELS))
    if got != STEP_KERNELS:
        raise AssertionError(f"config4 train step launched {got}, expected "
                             f"{STEP_KERNELS}")


def _check_step_maps(name, items) -> int:
    """The block masks' tile maps a profiled multitoken train step built:
    block_tile_map_kernel's launches and device ms, one a bf16 forward
    call of attn_block_3d on a stream longer than one key tile (the
    backward reuses its forward's). Raises if the step built none."""
    ms, n = _by_kernel(items, ("block_tile_map_kernel",)).get(
        "block_tile_map_kernel", [0.0, 0])
    print(f"profile {name} train step: block_tile_map_kernel x{n} "
          f"{ms:.4f} ms device")
    if not n:
        raise AssertionError(f"{name}: the train step built no tile map")
    return n


def run_config(name: str, argv, power: str, timed: bool) -> dict:
    """Drive one BASELINE configuration's eval step at full width: the
    launch counts of its run (reset just before, read just after), the
    plain path in bf16 and, on the same weights, in fp32, the Evaluator,
    and (``timed``) ms/step on both paths in turns."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = parse_config(argv)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.tie_len, cfg.precision)
    if widths != (256, 6, 4, TIE_LEN, "bf16"):
        raise AssertionError(f"{name} defaults changed: {widths}")
    fracs = BATCHES[name]
    batches = [synthetic_batch(cfg, BATCH, seed=s, present_frac=f)
               for s, f in enumerate(fracs)]
    model = get_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, device=dev, eval_only=True)

    # the main path: every kernel launch of these steps is counted
    ops.reset_launches()
    probs, losses, rows = _eval_steps(trainer, batches)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    n = len(batches)
    print(f"{name}: launches over {n} eval steps: {counts}; trunk rows per "
          f"step {rows}")
    for kernel in ops.KERNELS:
        want = LAUNCHES_PER_STEP[name].get(kernel, 0) * n
        if counts[kernel] != want:
            raise AssertionError(f"{name} {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")
    # a path whose batches overflow the packed trunk takes both branches,
    # and both are held in fp32 below
    overflow = _overflow_batch(cfg, model, batches, fracs)
    if overflow:
        _check_trunk_rows(name, cfg, rows)
    if probs.shape[0] != BATCH * n or probs.ndim != (
            1 if cfg.output_dim == 1 else 2) or not np.all(
                np.isfinite(probs)):
        raise AssertionError(f"bad probabilities {probs.shape}")
    with ops.reference_path():
        ref_probs, ref_losses, _ = _eval_steps(trainer, batches)
    d_bf16 = float(np.max(np.abs(probs - ref_probs)))
    print(f"{name} bf16: max |prob - plain prob| = {d_bf16:.3e} "
          f"(tol {PROB_TOL['bf16']}); loss {np.mean(losses):.5f} vs plain "
          f"{np.mean(ref_losses):.5f}")
    if d_bf16 > PROB_TOL["bf16"]:
        raise AssertionError(f"{name}: bf16 path disagrees with the plain "
                             "path")

    # the Evaluator of a classification run: phase 18's drivers
    if cfg.model_types == "detection":
        ev = Evaluator()
        for i, batch in enumerate(batches):
            ev.add_batch(batch["target"], probs[i * BATCH:(i + 1) * BATCH])
        metrics = ev.performance_metric()
        print(f"{name} evaluator (random weights): " + ", ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics {metrics}")

    if timed:
        # timing in turns: plain, kernel, kernel, plain
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_ms(trainer, batches, reference))
        kernel_ms, plain_ms = np.mean(ms[False]), np.mean(ms[True])
        print(f"{name} eval step ({power}): kernels {kernel_ms:.2f} ms/step "
              f"({BATCH * 1e3 / kernel_ms:.1f} samples/s), plain "
              f"{plain_ms:.2f} ms/step ({BATCH * 1e3 / plain_ms:.1f} "
              f"samples/s); rounds {ms[False]} / {ms[True]}")
        if name == "config4":
            _profile_step(name, trainer, batches[0], power)

    # the same weights in fp32: a tight check of the kernel path (on a
    # packed and on the overflowing batch where the path has both)
    state = model.state_dict()
    del trainer, model
    cfg32 = cfg.replace(precision="fp32")
    model32 = get_model(cfg32, state=state)
    trainer32 = Trainer(cfg32, model32, device=dev, eval_only=True)
    checked = [batches[0]] + overflow
    p32, _, _ = _eval_steps(trainer32, checked)
    with ops.reference_path():
        r32, _, _ = _eval_steps(trainer32, checked)
    d32 = float(np.max(np.abs(p32 - r32)))
    print(f"{name} fp32: max |prob - plain prob| = {d32:.3e} "
          f"(tol {PROB_TOL['fp32']})")
    if d32 > PROB_TOL["fp32"]:
        raise AssertionError(f"{name}: fp32 path disagrees with the plain "
                             "path")
    del trainer32, model32
    torch.cuda.empty_cache()
    return counts


def _overflow_batch(cfg, model, batches, fracs) -> list:
    """The first batch with more images than the packed trunk holds, in a
    list, where the model packs its single-image trunk; else []. A path
    with one runs both trunk branches: cap + 1 rows and all of them."""
    from medical_tri_modal_pilot_tpu_torch.models.models import pack_capacity
    if not getattr(model, "img_pack", False) or cfg.multiimages == 1:
        return []
    cap = pack_capacity(cfg, BATCH)
    return [b for b, f in zip(batches, fracs)
            if round(f * BATCH) > cap][:1]


def _check_trunk_rows(name, cfg, rows) -> None:
    from medical_tri_modal_pilot_tpu_torch.models.models import pack_capacity
    cap = pack_capacity(cfg, BATCH)
    if cap + 1 not in rows or BATCH not in rows:
        raise AssertionError(f"{name}: trunk rows {rows} miss the packed "
                             f"({cap + 1}) or the overflow ({BATCH}) "
                             "branch")


def _train_run(cfg, state, batch, plain):
    """One train step from ``state`` on one path: (loss, gradients and
    updated values of the trainable parameters, the step's learning
    rate). ``plain``: True for the plain path, False for the kernels, or
    the ``ops`` wrappers that take their plain versions while the others
    launch their kernels."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    model = get_model(cfg, state=state)
    tr = Trainer(cfg, model, torch.device("cuda"), eval_only=False, seed=0)
    lr = tr.current_lr()
    names = () if plain is True else tuple(plain or ())
    with (ops.reference_path(*names) if plain
          else contextlib.nullcontext()):
        loss = tr.train_step(batch)
    torch.cuda.synchronize()
    params = tr.optimizer.params
    names = {id(p): n for n, p in model.named_parameters()}
    out = {names[id(p)]: (p.grad.float().clone(), p.detach().float().clone())
           for p in params}
    del tr, model
    torch.cuda.empty_cache()
    return loss, out, lr


# tensors whose true gradient is 0, so that both paths hold rounding noise
# there: a key-projection bias (softmax is shift invariant per query), and
# the biases the head's BatchNorm cancels (fc_list.0 and the LayerNorm
# before it add the same vector to every sample: layer_norms_after_concat
# in tri_mbt_vsltcls and the bimodal v1 models, final_ln in the cross
# transformer, layer_norm_final in unimodal_transformer; each head
# fc_list_{m} of tri_mbt_vnosh*, and the LayerNorm before them; gru_d's
# fc1, before its BatchNorm bn). A LayerNorm
# head (ClsHeadLN, tri_mbt_v1's, with no running statistics) normalises
# each sample over its features, which cancels neither
ZERO_GRAD = ("key_proj.linear.bias", "fc_list.0.bias",
             "layer_norms_after_concat.bias", "final_ln.bias",
             "layer_norm_final.bias", "fc_list_0.0.bias", "fc_list_1.0.bias",
             "fc_list_2.0.bias", "fc1.bias")


def _step_errors(a, b, zero=ZERO_GRAD):
    """|a - b|_F / |b|_F per trainable tensor with a nonzero true
    gradient (the rest named by ``zero``)."""
    return {n: _grad_errors([a[n][0]], [b[n][0]])[0] for n in b
            if not n.endswith(zero)}


def _summary(errs) -> str:
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:2]
    bad = [n for n, e in errs.items() if not np.isfinite(e)]
    return (f"median {statistics.median(errs.values()):.3e}, max "
            f"{max(errs.values()):.3e} {[(n, round(e, 4)) for n, e in worst]}"
            + (f"; not finite: {bad}" if bad else ""))


class StepAllowance(NamedTuple):
    """What phase 20 allows one named run (LG_ALLOW) beside phase 15's
    step gates, each printed where it acts; the default allows nothing.
    ``loss_relative``: the loss gate's tolerance relative past a loss of
    1 (fp32 resolves AUXCPC's l2 / cpc losses of up to 1.75e5 at the
    reference's init only to 2^-6). ``ulp_params``: tensors whose update
    bound adds two of their fp32 units in the last place at their largest
    entry (``ct_weight``, up to 22.6, rounds a step of lr to 2^-19).
    ``noise_floor``: an fp32 gradient past STEP_FP32_TOL passes within
    STEP_NOISE_RATIO of the plain path's own distance from itself under
    input noise (_noise_floor), which no kernel enters. ``bf16_held``:
    (tensor suffix, reference suffix) pairs; the tensor's bf16 gradient
    leaves the ratio statistics and its kernel-path distance from the fp32
    plain step, |kernel - fp32|_F, must stay within STEP_BF16_RATIO of the
    plain path's bf16 distance on the reference tensor."""
    loss_relative: bool = False
    ulp_params: tuple = ()
    noise_floor: bool = False
    bf16_held: tuple = ()


# the noise floor's relative input noise and draws, and the ratio to it
STEP_NOISE, STEP_NOISE_DRAWS, STEP_NOISE_RATIO = 1e-6, 3, 2.0


def _check_step_parity(name, cfg, state, batch, precs, zero_grad=(),
                       allow: Optional[StepAllowance] = None) -> None:
    """One step from the same weights on the kernel and the plain path,
    for each (precision, dropout) in ``precs``; every bf16 entry needs an
    fp32 one at its dropout, the step its gradients are held against.
    ``zero_grad``: more tensors whose true gradient is 0; ``allow``: a
    named run's StepAllowance (None: the gates above alone)."""
    allow = allow or StepAllowance()
    batchnorm_head = any(k.endswith(("1.running_mean", "bn.running_mean"))
                         for k in state)
    zero = (ZERO_GRAD if batchnorm_head else ZERO_GRAD[:1]) + zero_grad
    runs, failures = {}, []
    for prec, p in precs:
        c = cfg.replace(precision=prec, dropout=p)
        for plain in (False, True):
            runs[prec, p, plain] = _train_run(c, state, batch, plain)
    for (prec, p, plain), (loss, got, lr) in runs.items():
        if plain:
            continue
        ref_loss, want, _ = runs[prec, p, True]
        errs = _step_errors(got, want, zero)
        # each side's Adam step is at most lr per element, plus the
        # parameter's fp32 rounding
        bound = {n: 2.01 * lr + (
            max(1e-7, 2.0 ** -22 * float(state[n].abs().max()))
            if allow.ulp_params and n.endswith(allow.ulp_params) else 1e-7)
            for n in want}
        diff = {n: float((got[n][1] - want[n][1]).abs().max()) for n in want}
        p_err = max(diff.values())
        over = [n for n in want if diff[n] > bound[n]]
        moved = max(float((got[n][1] - state[n].float().cuda()).abs().max())
                    for n in want)
        ulp = [(n, f"{bound[n]:.3e}") for n in want
               if allow.ulp_params and n.endswith(allow.ulp_params)]
        print(f"{name} train step {prec} dropout {p}: loss {loss:.6f} vs "
              f"plain {ref_loss:.6f}; grads |kernel - plain|_F/|plain|_F "
              f"over {len(errs)} tensors: {_summary(errs)}; updated params "
              f"max |diff| {p_err:.3e} (bound {2.01 * lr + 1e-7:.3e} = "
              f"2.01 lr + 1e-7" + (f"; with 2 ulp {ulp}" if ulp else "")
              + f"; past it: {over}; moved up to {moved:.3e})")
        loss_tol = STEP_LOSS_TOL[prec] * (
            max(1.0, abs(ref_loss)) if allow.loss_relative else 1.0)
        if not np.isfinite(loss) or abs(loss - ref_loss) > loss_tol:
            failures.append(f"{prec} {p}: loss")
        if over or moved == 0.0:
            failures.append(f"{prec} {p}: updated parameters")
        if prec == "fp32":
            if max(errs.values()) > STEP_FP32_TOL and not (
                    allow.noise_floor and _within_noise_floor(
                        name, cfg.replace(precision=prec, dropout=p), state,
                        batch, errs, want, zero)):
                failures.append(f"fp32 {p}: gradients")
            continue
        fp32 = runs["fp32", p, True][1]
        k_err = _step_errors(got, fp32, zero)
        p_err32 = _step_errors(want, fp32, zero)
        held = {n: n[:-len(t)] + r for n in k_err for t, r in allow.bf16_held
                if n.endswith(t)}
        if held:
            failures += _check_held(name, p, held, got, want, fp32)
            k_err = {n: e for n, e in k_err.items() if n not in held}
            p_err32 = {n: e for n, e in p_err32.items() if n not in held}
        print(f"{name} train step dropout {p}, bf16 against the fp32 plain "
              f"step: kernel path {_summary(k_err)}; plain path "
              f"{_summary(p_err32)}")
        if not all(np.isfinite(e) for e in k_err.values()):
            failures.append(f"bf16 {p}: gradients not finite")
        for stat in (statistics.median, max):
            if stat(k_err.values()) > STEP_BF16_RATIO * stat(
                    p_err32.values()) + 1e-2:
                failures.append(f"bf16 {p}: {stat.__name__} against fp32")
    if failures:
        raise AssertionError(f"{name} train step parity: {failures}")


def _check_held(name, p, held, got, want, fp32) -> list:
    """StepAllowance.bf16_held: each tensor's kernel-path bf16 gradient
    distance from the fp32 plain step, |kernel - fp32|_F, against
    STEP_BF16_RATIO times the plain path's bf16 distance on its reference
    tensor; the failures."""
    def dist(a, n):
        return float((a[n][0].float() - fp32[n][0].float()).norm())
    rows = [(n, dist(got, n), dist(want, n), float(fp32[n][0].norm()), r,
             dist(want, r)) for n, r in held.items()]
    print(f"{name} train step dropout {p}, bf16 held tensors (|kernel - "
          f"fp32|_F, |plain - fp32|_F, |fp32|_F; bound {STEP_BF16_RATIO} x "
          f"the plain path's |plain - fp32|_F on the reference): "
          + "; ".join(f"{n} {k:.3e} {pl:.3e} {f:.3e} (bound "
                      f"{STEP_BF16_RATIO * rp:.3e} from {r})"
                      for n, k, pl, f, r, rp in rows))
    bad = [n for n, k, _, _, _, rp in rows
           if not np.isfinite(k) or k > STEP_BF16_RATIO * rp]
    return [f"bf16 {p}: held tensors {bad}"] if bad else []


def _noisy(batch, seed: int) -> dict:
    """``batch`` with relative noise of STEP_NOISE on its measured inputs:
    the vital-sign values (the carryforward grid's data plane), the note
    embeddings, the images."""
    rng = np.random.default_rng(seed)
    out = dict(batch)

    def jitter(a):
        return (a * (1 + STEP_NOISE * rng.standard_normal(a.shape))
                ).astype(a.dtype)
    v = batch["vslt"]
    if v.ndim == 4:                               # [B, 3, T, F]: data plane
        out["vslt"] = v.copy()
        out["vslt"][:, 0] = jitter(v[:, 0])
    for k in ("txt", "img"):
        if k in batch and np.issubdtype(batch[k].dtype, np.floating):
            out[k] = jitter(batch[k])
    return out


def _within_noise_floor(name, cfg, state, batch, errs, want, zero) -> bool:
    """Whether each tensor's kernel-path fp32 gradient distance in
    ``errs`` from the plain step ``want`` past STEP_FP32_TOL lies within
    STEP_NOISE_RATIO of the noise floor there: the largest over
    STEP_NOISE_DRAWS draws of the plain path's distance from ``want`` when
    the batch carries STEP_NOISE of relative input noise (_noisy). No
    kernel runs in the floor."""
    floor = {}
    for seed in range(STEP_NOISE_DRAWS):
        e = _step_errors(_train_run(cfg, state, _noisy(batch, seed),
                                    True)[1], want, zero)
        floor = {n: max(v, floor.get(n, 0.0)) for n, v in e.items()}
    past = {n: (e, floor[n]) for n, e in errs.items()
            if e > STEP_FP32_TOL}
    ok = all(e <= STEP_NOISE_RATIO * f for e, f in past.values())
    shown = [(n, round(e, 4), round(f, 4)) for n, (e, f) in past.items()]
    print(f"{name} fp32 step past {STEP_FP32_TOL} in {len(past)} tensors "
          f"(kernel path, the plain path under {STEP_NOISE} relative input "
          f"noise, the largest of {STEP_NOISE_DRAWS} draws): {shown[:6]}; "
          f"the noise floor {_summary(floor)}; within {STEP_NOISE_RATIO}x: "
          f"{ok}")
    return ok


def _timed_train_ms(trainer, batches, reference: bool) -> float:
    from medical_tri_modal_pilot_tpu_torch import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.reference_path() if reference else contextlib.nullcontext():
        for batch in batches:
            trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


# the kernel path's train ms/step of each timed run_train (phase 7's
# config-4 figure stands beside the driver's in phase 14)
TRAIN_STEP_MS = {}


def run_train(name: str, argv, power: str, timed: bool,
              all_parity: bool = False, fit: bool = True) -> dict:
    """Drive one BASELINE configuration's train step at full width: the
    launch counts of its run (reset just before, read just after), peak
    memory, kernel vs plain path on one step (at dropout 0.1, and 0 too
    when ``timed`` or ``all_parity``), and (``timed``) ms/step on both
    paths in turns, a profiler split and (``fit``) 20 steps on one
    batch."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = parse_config(argv)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.tie_len, cfg.precision,
              cfg.dropout, cfg.optim)
    if widths != (256, 6, 4, TIE_LEN, "bf16", 0.1, "adamw"):
        raise AssertionError(f"{name} defaults changed: {widths}")
    batches = [synthetic_batch(cfg, BATCH, seed=10 + s, present_frac=f)
               for s, f in enumerate(TRAIN_BATCHES[name])]
    model = get_model(cfg, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, dev, eval_only=False, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every kernel launch of these steps is counted, and the
    # shapes of its dropout masks are recorded
    masks, dispatch = [], ops.dropout_masks

    def record(R, F, C, *args, col0=0, row0=0):
        masks.append((R, F, C, col0))
        return dispatch(R, F, C, *args, col0=col0, row0=row0)

    ops.dropout_masks = record
    ops.reset_launches()
    losses, rows = [], []
    try:
        for batch in batches:
            losses.append(trainer.train_step(batch))
            rows.append(getattr(model, "trunk_rows", 0))
        torch.cuda.synchronize()
    finally:
        ops.dropout_masks = dispatch
    counts = dict(ops.launches)
    recomputes = dict(ops.recomputes)
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    print(f"{name}: launches over {n} train steps: {counts}; trunk rows per "
          f"step {rows}; losses {losses}")
    # plain recomputes of a Swin op's backward: none on the kernel path
    want = {k: TRAIN_RECOMPUTES_PER_STEP.get(name, {}).get(k, 0) * n
            for k in ops.RECOMPUTES}
    print(f"{name}: Swin backward recomputes over {n} train steps: "
          f"{recomputes}")
    if recomputes != want:
        raise AssertionError(f"{name} train: Swin backward recomputes "
                             f"{recomputes}, expected {want}")
    print(f"{name} train peak device memory: {peak / 2 ** 30:.3f} GiB "
          f"(parameters, optimizer state and batch before the steps "
          f"{base / 2 ** 30:.3f} GiB)")
    for kernel in ops.KERNELS:
        want = TRAIN_LAUNCHES_PER_STEP[name].get(kernel, 0) * n
        if counts[kernel] != want:
            raise AssertionError(f"{name} train {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite train loss {losses}")
    if name == "config4":
        want = {v for k, v in MASK_SHAPES.items() if k.startswith("input")}
        if set(masks) != want:
            raise AssertionError(f"{name}: dropout masks of shapes "
                                 f"{sorted(set(masks))}, MASK_SHAPES has "
                                 f"{sorted(want)}")
    if _overflow_batch(cfg, model, batches, TRAIN_BATCHES[name]):
        _check_trunk_rows(name, cfg, rows)

    if timed:
        # in turns: plain, kernel, kernel, plain
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_train_ms(trainer, batches,
                                                 reference))
        kernel_ms, plain_ms = np.mean(ms[False]), np.mean(ms[True])
        TRAIN_STEP_MS[name] = kernel_ms
        print(f"{name} train step ({power}): kernels {kernel_ms:.2f} ms/step "
              f"({BATCH * 1e3 / kernel_ms:.1f} samples/s), plain "
              f"{plain_ms:.2f} ms/step ({BATCH * 1e3 / plain_ms:.1f} "
              f"samples/s); rounds {ms[False]} / {ms[True]}")
        items = _profile_step(name, trainer, batches[0], power, train=True)
        if name == "config4":
            _check_step_kernels(items)
        if name in MULTI_PATHS:
            _check_step_maps(name, items)

    if timed and fit:
        # 20 steps on one batch from the starting weights: the loss falls
        model.load_state_dict(state)
        fitter = Trainer(cfg, model, dev, eval_only=False, seed=0)
        curve = [fitter.train_step(batches[0]) for _ in range(20)]
        print(f"{name} 20 steps on one batch: losses "
              f"{[round(x, 5) for x in curve]}")
        if not all(np.isfinite(curve)) or not (
                np.mean(curve[-5:]) < np.mean(curve[:5])):
            raise AssertionError(f"{name}: the loss does not fall on one "
                                 f"batch: {curve}")
        del fitter
    del trainer, model
    torch.cuda.empty_cache()

    # one step from the same weights on both paths; the plain path draws
    # the same Philox masks
    parity = ([("fp32", 0.0), ("bf16", 0.0), ("fp32", 0.1), ("bf16", 0.1)]
              if (timed and fit) or all_parity
              else [("fp32", 0.1), ("bf16", 0.1)])
    _check_step_parity(name, cfg, state, batches[0], parity)
    return counts


# tensor parallelism: config 4 under --mp-size 2 in two ranks on the one
# card, at TP_LAYERS of its 6 layers (two ranks sharing one card over
# gloo time no TP speed, and every phase shares the script's time
# limit); the batches (images for 32, 16 and 48 of 64 samples: the
# packed trunk and its overflow) and, per step and rank, the launches:
# the forward's as config 4's with attn_block and ffn off, the vslt
# stream's attention through rowmm_ln (one a layer), every stream's
# through attention (3 a layer); the backward as config 4's (the last
# layer's img and txt streams get none); one dropout_masks per FFN (3 a
# layer) and per stream's input dropout (3)
TP_LAYERS = 2
TP_ARGV = CONFIG4 + ["--mp-size", "2", "--dp-size", "1",
                     "--transformer-num-layers", str(TP_LAYERS)]
TP_BATCHES = [0.5, 0.25, 0.75]
TP_EVAL_LAUNCHES = {"umse": 1, "attention": 3 * TP_LAYERS,
                    "rowmm_ln": TP_LAYERS, "swin_attention": 12,
                    "swin_mlp": 12}
TP_TRAIN_LAUNCHES = dict(TP_EVAL_LAUNCHES, umse_bwd=1,
                         attention_bwd=3 * TP_LAYERS - 2,
                         rowmm_ln_bwd=TP_LAYERS,
                         dropout_masks=3 * TP_LAYERS + 3)
TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "tp_smoke")
TP_LABEL = "2 ranks share one H100 over gloo: not a TP speed figure"
# the TP loss curve: steps on one batch, and the gate compares the mean of
# its first and last TP_CURVE_MEAN (over 8 steps the last 3 against the
# first 3 could miss on rounding alone; over 32 the means part clearly)
TP_CURVE_STEPS = 32
TP_CURVE_MEAN = 8


def _tp_batches(cfg):
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    return [synthetic_batch(cfg, BATCH, seed=30 + s, present_frac=f)
            for s, f in enumerate(TP_BATCHES)]


def _check_counts(what, counts, per_step, steps):
    from medical_tri_modal_pilot_tpu_torch import ops
    for kernel in ops.KERNELS:
        want = per_step.get(kernel, 0) * steps
        if counts[kernel] != want:
            raise AssertionError(f"{what} {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")


def tp_rank(out_dir: str) -> None:
    """One rank of the tensor-parallel phase (started by parallel.launch):
    the same steps on every rank, rank 0 prints; each rank writes its
    numbers to ``out_dir``/rank{r}.pt, rank 0 also the probabilities and
    the gathered fp32 gradients."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.models.modules import DropoutSeeds
    from medical_tri_modal_pilot_tpu_torch.parallel.distributed import \
        maybe_init_distributed
    from medical_tri_modal_pilot_tpu_torch.parallel.mesh import (
        gather_state_dict, make_mesh)
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    rank, world = maybe_init_distributed(None, "gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    dev = torch.device("cuda")
    cfg = parse_config(TP_ARGV)
    mesh = make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
    batches = _tp_batches(cfg)
    n = len(batches)
    res = {}

    def trainer(c, eval_only=True):
        model = get_model(c, torch.Generator().manual_seed(0))
        return Trainer(c, model, dev, eval_only=eval_only, seed=0, mesh=mesh)

    # eval, bf16: the main path's launches, then ms/step
    tr = trainer(cfg)
    ops.reset_launches()
    probs, _, _ = _eval_steps(tr, batches)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    say(f"tp rank {rank}/{world}: launches over {n} eval steps: {counts}")
    _check_counts(f"tp rank {rank} eval", counts, TP_EVAL_LAUNCHES, n)
    res["eval_ms"] = _timed_ms(tr, batches, reference=False)
    res["probs"] = probs
    del tr
    tr32 = trainer(cfg.replace(precision="fp32"))
    res["probs32"], _, _ = _eval_steps(tr32, batches[:1])
    del tr32

    # one fp32 train step at dropout 0.1 from the seeded weights: the
    # gradients, gathered into whole tensors
    c32 = cfg.replace(precision="fp32", dropout=0.1)
    tr32 = trainer(c32, eval_only=False)
    res["loss32"] = tr32.train_step(batches[0])
    names = {id(p): nm for nm, p in tr32.model.named_parameters()}
    grads = {names[id(p)]: p.grad.detach().float()
             for p in tr32.optimizer.params}
    grads = gather_state_dict(grads, tr32.split, mesh)
    res["grads"] = {k: v.cpu() for k, v in grads.items()} if rank == 0 \
        else None
    res["replicated_grads"] = {k: v.cpu() for k, v in grads.items()
                               if k not in tr32.split}
    del tr32, grads
    # the same step in bf16, gathered
    tr16 = trainer(cfg.replace(dropout=0.1), eval_only=False)
    res["loss16"] = tr16.train_step(batches[0])
    names = {id(p): nm for nm, p in tr16.model.named_parameters()}
    grads = gather_state_dict({names[id(p)]: p.grad.detach().float()
                               for p in tr16.optimizer.params}, tr16.split,
                              mesh)
    res["grads16"] = {k: v.cpu() for k, v in grads.items()} if rank == 0 \
        else None
    del tr16, grads
    torch.cuda.empty_cache()

    # train, bf16: launches, peak memory, ms/step, a profiler split, the
    # loss over steps on one batch
    tr = trainer(cfg, eval_only=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses = [tr.train_step(b) for b in batches]
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    res["peak"], res["base"] = torch.cuda.max_memory_allocated(), base
    res["train_counts"] = counts
    say(f"tp rank {rank}: launches over {n} train steps: {counts}; losses "
        f"{losses}")
    _check_counts(f"tp rank {rank} train", counts, TP_TRAIN_LAUNCHES, n)
    res["train_ms"] = _timed_train_ms(tr, batches, reference=False)
    res["profile"] = _profile_tp_step(tr, batches[0], rank)
    curve = [tr.train_step(batches[0]) for _ in range(TP_CURVE_STEPS)]
    res["curve"] = curve
    say(f"tp {TP_CURVE_STEPS} steps on one batch (after {2 * n + 2} "
        f"others): losses {[round(x, 5) for x in curve]}")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _profile_tp_step(trainer, batch, rank: int) -> dict:
    """torch.profiler over one train step: the device's busy time and the
    host wall; and the host's time blocked in the collective calls (a
    clock around each all_reduce and all_gather, which return once gloo
    has staged the tensor through the host, exchanged it and copied it
    back, so the time includes the device work queued before it)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    torch.cuda.synchronize()
    blocked = {"s": 0.0, "calls": 0}

    def timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                blocked["s"] += time.perf_counter() - t
                blocked["calls"] += 1
        return call
    plain = dist.all_reduce, dist.all_gather
    dist.all_reduce, dist.all_gather = map(timed, plain)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce, dist.all_gather = plain
    events = prof.key_averages()

    busy = sum(_dev_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    copies = sum(_dev_us(e) for e in events if e.device_type ==
                 DeviceType.CUDA and "Memcpy" in e.key) / 1e3
    items = [(_dev_us(e), e.count, e.key) for e in events
             if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    return {"wall_ms": wall, "busy_ms": busy,
            "blocked_ms": blocked["s"] * 1e3, "blocked_calls":
            blocked["calls"], "copy_ms": copies,
            "top": sorted(((t / 1e3, n, k) for t, n, k in items),
                          reverse=True)[:12],
            "rowmm": _by_kernel(items, [k for forms in
                                        ROWMM_ROUTE_KERNELS.values()
                                        for ks in forms for k in ks])}


def run_tp(power: str) -> dict:
    """The tensor-parallel phase: single-process references on the card,
    then two ranks of tp_rank, then the comparisons. Returns rank 0's train
    launch counts."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda")
    single = parse_config(TP_ARGV).replace(mp_size=0, dp_size=0)
    batches = _tp_batches(single)

    def trainer(c):
        return Trainer(c, get_model(c, torch.Generator().manual_seed(0)),
                       dev, eval_only=True)

    probs, _, _ = _eval_steps(trainer(single), batches)
    c32 = single.replace(precision="fp32")
    probs32, _, _ = _eval_steps(trainer(c32), batches[:1])
    state = get_model(c32, torch.Generator().manual_seed(0)).state_dict()
    loss32, ref, _ = _train_run(c32.replace(dropout=0.1), state, batches[0],
                                plain=False)
    # the bf16 step's yardsticks: the fp32 plain step, and the single
    # process's bf16 kernel-path step held against it
    _, ref32, _ = _train_run(c32.replace(dropout=0.1), state, batches[0],
                             plain=True)
    loss16, ref16, _ = _train_run(single.replace(dropout=0.1), state,
                                  batches[0], plain=False)
    torch.cuda.empty_cache()

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    t0 = time.perf_counter()
    launch("chip_smoke:tp_rank", 2, f"file://{TP_DIR}/rendezvous", [TP_DIR],
           timeout=900)
    print(f"tp: two ranks done in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(TP_DIR, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    r0 = ranks[0]
    d_bf16 = float(np.max(np.abs(r0["probs"] - probs)))
    d32 = float(np.max(np.abs(r0["probs32"] - probs32)))
    same = float(np.max(np.abs(r0["probs"] - ranks[1]["probs"])))
    print(f"tp config 4 eval, against the single-process kernel path: max "
          f"|prob diff| bf16 {d_bf16:.3e} (tol {PROB_TOL['bf16']}), fp32 "
          f"{d32:.3e} (tol {PROB_TOL['fp32']}); the two ranks' "
          f"probabilities differ by {same:.3e}")
    errs = _step_errors({k: (v.to(dev), None) for k, v in r0["grads"].items()},
                        ref)
    print(f"tp fp32 train step dropout 0.1: loss {r0['loss32']:.6f} vs single "
          f"{loss32:.6f}; grads |tp - single|_F/|single|_F over {len(errs)} "
          f"tensors: {_summary(errs)} (tol {STEP_FP32_TOL})")
    tp16 = {k: (v.to(dev), None) for k, v in r0["grads16"].items()}
    e_tp, e_single = _step_errors(tp16, ref32), _step_errors(ref16, ref32)
    print(f"tp bf16 train step dropout 0.1: loss {r0['loss16']:.6f} vs single "
          f"{loss16:.6f}; against the fp32 plain step: tp {_summary(e_tp)}; "
          f"single process {_summary(e_single)}")
    bf16_ok = all(stat(e_tp.values()) <= STEP_BF16_RATIO * stat(
        e_single.values()) + 1e-2 for stat in (statistics.median, max))
    rep = [k for k in ranks[0]["replicated_grads"]
           if not torch.equal(ranks[0]["replicated_grads"][k],
                              ranks[1]["replicated_grads"][k])]
    print(f"tp: replicated gradients equal on both ranks: {not rep} "
          f"({len(ranks[0]['replicated_grads'])} tensors)")
    for r, res in enumerate(ranks):
        prof = res["profile"]
        print(f"tp rank {r} ({power}; {TP_LABEL}): eval {res['eval_ms']:.1f} "
              f"ms/step, train {res['train_ms']:.1f} ms/step, peak device "
              f"memory {res['peak'] / 2 ** 30:.3f} GiB (before the steps "
              f"{res['base'] / 2 ** 30:.3f} GiB); profiled train step: wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
              f"ms (idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}),"
              f" host blocked in {prof['blocked_calls']} collective calls "
              f"{prof['blocked_ms']:.1f} ms "
              f"({prof['blocked_ms'] / prof['wall_ms']:.3f} of the wall), "
              f"device copies {prof['copy_ms']:.1f} ms")
    for t, count, key in r0["profile"]["top"]:
        print(f"  device {t:8.3f} ms x{count:<4d} {key[:90]}")
    print("tp rank 0 rowmm kernels in the step: " + ", ".join(
        f"{k} x{n} {t:.3f} ms" for k, (t, n) in
        r0["profile"]["rowmm"].items()))
    curve = r0["curve"]
    head, tail = (float(np.mean(curve[:TP_CURVE_MEAN])),
                  float(np.mean(curve[-TP_CURVE_MEAN:])))
    print(f"tp loss over {len(curve)} steps on one batch: mean of the first "
          f"{TP_CURVE_MEAN} {head:.5f}, of the last {TP_CURVE_MEAN} "
          f"{tail:.5f}")
    failures = []
    if d_bf16 > PROB_TOL["bf16"] or d32 > PROB_TOL["fp32"] or same != 0.0:
        failures.append("eval probabilities")
    if abs(r0["loss32"] - loss32) > STEP_LOSS_TOL["fp32"] or \
            max(errs.values()) > STEP_FP32_TOL:
        failures.append("fp32 train step")
    if abs(r0["loss16"] - loss16) > STEP_LOSS_TOL["bf16"] or not bf16_ok:
        failures.append("bf16 train step against the fp32 step")
    if rep:
        failures.append(f"replicated gradients differ: {rep[:3]}")
    if not all(np.isfinite(curve)) or not tail < head:
        failures.append(f"the loss does not fall: {curve}")
    if failures:
        raise AssertionError(f"tensor parallelism: {failures}")
    return r0["train_counts"]


# phase 14, the drivers: config 4 through drivers.train.run_fold at full
# width over seeded synthetic loaders in the real loader's wire format
# (uint8 CXRs packed at --img-pack-frac 0.55: capacity 36, so 32 and 16
# images pack and 48 overflow to the dense uint8 wire; notes as txt_id rows
# into the batches' note table), two epochs of 4 train batches, 2 val and
# 2 test batches, an asynchronous save every 3 steps
DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "driver_smoke")
DRIVER_ARGV = CONFIG4 + ["--img-pack-frac", "0.55", "--epochs", "2",
                         "--checkpoint-every", "3", "--log-iter", "1",
                         "--dir-result", DRIVER_DIR,
                         "--project-name", "drivers"]
DRIVER_BATCHES = {"train": [0.5, 0.25, 0.75, 0.5], "val": [0.5, 0.25],
                  "test": [0.5, 0.75]}


def _driver_loaders(cfg, splits=None):
    """The run's wire batches per split (``splits``: the present-image
    fraction of each batch by split, DRIVER_BATCHES by default), their
    dense form and the note table."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
        synthetic_batch, to_wire)
    splits = splits or DRIVER_BATCHES
    names, batches = [], []
    for split, fracs in splits.items():
        for f in fracs:
            names.append(split)
            batches.append(synthetic_batch(cfg, BATCH, seed=200 + len(names),
                                           present_frac=f))
    wire, dense, table = to_wire(batches)
    split = lambda bs: {k: [b for n, b in zip(names, bs) if n == k]
                        for k in splits}
    return split(wire), split(dense), table


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _state_equal(what, got, want) -> None:
    """Model and optimizer state_dicts equal bit for bit."""
    (gm, go), (wm, wo) = got, want
    bad = [k for k in wm if not torch.equal(gm[k].cpu(), wm[k].cpu())]
    bad += [f"opt {i} {k}" for i, st in wo["state"].items()
            for k, v in st.items()
            if not torch.equal(go["state"][i][k].cpu(), v.cpu())]
    if gm.keys() != wm.keys() or go["state"].keys() != wo["state"].keys() \
            or bad:
        raise AssertionError(f"{what}: not bit for bit: {bad[:8]}")


def run_drivers(power: str) -> None:
    """Phase 14: the train driver's fold at full width, then its run
    record, the wire format and buckets, the step-3 async save against a
    Trainer stepped 3 times, a resume, and the test driver's walk."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.logger import (
        Logger, make_setting_file)
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    cfg = parse_config(DRIVER_ARGV)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.tie_len, cfg.precision,
              cfg.dropout, cfg.optim, cfg.batch_size)
    if widths != (256, 6, 4, TIE_LEN, "bf16", 0.1, "adamw", BATCH):
        raise AssertionError(f"driver run defaults changed: {widths}")
    wire, dense, table = _driver_loaders(cfg)
    loaders = [BatchList(wire[k]) for k in ("train", "val", "test")]
    root = os.path.join(DRIVER_DIR, cfg.project_name)
    last = ckpt.ckpt_path(DRIVER_DIR, cfg.project_name, "last", 0, cfg.seed)
    best = ckpt.ckpt_path(DRIVER_DIR, cfg.project_name, "best", 0, cfg.seed)
    step3 = os.path.join(root, "step3.pth")

    # keep the step-3 save, which later saves overwrite, as it is written
    write = ckpt._write

    def keep_step3(path, payload):
        write(path, payload)
        if payload["step"] == 3 and path == last:
            shutil.copyfile(path, step3)

    # the main path: every kernel launch of the run is counted
    make_setting_file(cfg)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    ckpt._write = keep_step3
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        val, test = train_drv.run_fold(cfg, 0, *loaders, txt_table=table)
        torch.cuda.synchronize()
    finally:
        ckpt._write = write
    run_s = time.perf_counter() - t0
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    n_train = 2 * len(wire["train"])
    n_eval = 2 * len(wire["val"]) + len(wire["test"])
    print(f"drivers: launches over {n_train} train and {n_eval} eval steps: "
          f"{counts}; val {val}; test {test}")
    for kernel in ops.KERNELS:
        want = (n_train * TRAIN_LAUNCHES_PER_STEP["config4"].get(kernel, 0)
                + n_eval * LAUNCHES_PER_STEP["config4"].get(kernel, 0))
        if counts[kernel] != want:
            raise AssertionError(f"drivers {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")

    # the run record
    events = _events(os.path.join(root, "logs_0", "events.jsonl"))
    losses = [e for e in events if e["tag"] == "train/loss"]
    vals = [e for e in events if e["tag"] == "val/loss"]
    lrs = {e["step"]: e["value"] for e in events if e["tag"] == "train/lr"}
    if ([e["step"] for e in losses] != list(range(1, n_train + 1))
            or not all(np.isfinite(e["value"]) for e in losses)
            or [e["step"] for e in vals] != [4, 8]):
        raise AssertionError(f"drivers: events {losses} {vals}")
    for path in (os.path.join(root, "settings.txt"), last, best, step3):
        if not os.path.exists(path):
            raise AssertionError(f"drivers: no {path}")
    if test is None or not np.isfinite(test["apr"]):
        raise AssertionError(f"drivers: test metrics {test}")
    # per-step wall time from the events' clock (each train/loss line is
    # written after its step), within an epoch: the validation sits between
    # epochs, and the first step has no line before it
    t = [e["t"] for e in losses]
    per = len(wire["train"])
    step_ms = [1e3 * (t[i] - t[i - 1]) for i in range(1, n_train)
               if i % per != 0]
    print(f"drivers train step ({power}): {statistics.median(step_ms):.2f} "
          f"ms/step median over {len(step_ms)} steps (driver, events "
          f"clock; async saves at steps 3 and 6 included) "
          f"{[round(x, 2) for x in step_ms]}"
          f"; Trainer only (phase 7): "
          f"{TRAIN_STEP_MS.get('config4', float('nan')):.2f} ms/step; "
          f"run {run_s:.2f} s; peak device memory {peak / 2 ** 30:.3f} GiB "
          "with the async snapshots")

    # the step-3 file, written while steps 4-8 ran, against a Trainer
    # stepped 3 times from the same weights and batches
    ref = Trainer(cfg, get_model(cfg), dev, eval_only=False,
                  iters_per_epoch=per, seed=cfg.seed, txt_table=table)
    for batch in wire["train"][:3]:
        ref.train_step(batch)
    pay = ckpt.load_checkpoint(step3)
    if (pay["step"], pay["last_step"], pay["epoch"]) != (3, 3, 1):
        raise AssertionError(f"drivers: step-3 file {pay['step']} "
                             f"{pay['last_step']} {pay['epoch']}")
    _state_equal("step-3 async save vs 3 Trainer steps",
                 (pay["model"], pay["optimizer"]), ref.state_dicts())
    mb = os.path.getsize(last) / 2 ** 20
    # the main thread's cost of a save: async (snapshot and copies
    # started) against save_checkpoint (gather to the host and write)
    saver = ckpt.AsyncCheckpointer()
    tmp = os.path.join(root, "timing.pth")
    ms = {"async": [], "sync": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(tmp, ref, 0.0, 1)
        ms["async"].append((time.perf_counter() - t0) * 1e3)
        saver.wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(tmp, ref, 0.0, 1)
        ms["sync"].append((time.perf_counter() - t0) * 1e3)
    print(f"drivers checkpoint ({power}): {mb:.1f} MB; main thread "
          f"{statistics.median(ms['async']):.1f} ms a save async vs "
          f"{statistics.median(ms['sync']):.1f} ms save_checkpoint "
          f"(rounds {[round(x, 1) for x in ms['async']]} / "
          f"{[round(x, 1) for x in ms['sync']]})")
    del ref, saver
    gc_collect()

    # the wire format: the dense fp32 batch and its wire form, packed (32
    # images) and over the capacity (48, dense uint8), bit for bit; a
    # batch of TIE lengths <= 256 at bucket 256 against full length
    model = get_model(cfg)
    ev = Trainer(cfg, model, dev, txt_table=table)
    for i in (0, 2):
        w, d = wire["train"][i], dense["train"][i]
        packed = "img_pack" in ev.wire_pack(w)
        if packed != (i == 0):
            raise AssertionError(f"drivers: batch {i} packed {packed}")
        pw, pd = ev.eval_step(w)[0], ev.eval_step(d)[0]
        if not np.array_equal(pw, pd):
            raise AssertionError(f"drivers: wire batch {i} (packed "
                                 f"{packed}) differs from its dense form by "
                                 f"{np.abs(pw - pd).max():.3e}")
    short = dict(dense["test"][0])
    short["input_length"] = np.minimum(short["input_length"], 256)
    short["vslt"] = short["vslt"].copy()
    short["vslt"][:, 256:] = 0.0
    if ev.device_batch(short)["vslt"].shape[1] != 256:
        raise AssertionError("drivers: the short batch is not at bucket 256")
    full = Trainer(cfg.replace(tie_buckets="off"), model, dev)
    ps, pf = ev.eval_step(short)[0], full.eval_step(short)[0]
    err = float(np.abs(ps - pf).max())
    print(f"drivers wire: dense and wire probabilities bit for bit (packed "
          f"and over capacity); bucket 256 vs {TIE_LEN}: max |diff| "
          f"{err:.3e}")
    if not err <= PROB_TOL["bf16"]:
        raise AssertionError(f"drivers: bucket 256 vs full {err:.3e}")
    del ev, full, model
    gc_collect()

    # the test driver over the checkpoint directory, the same test batches
    walked = test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                      BatchList(wire["test"]), table)
    got = dict(walked).get(best)
    print(f"drivers test driver: {[(os.path.basename(p), m['auc'], m['apr']) for p, m in walked]}")
    if got != test:
        raise AssertionError(f"drivers: test driver {got} vs the train "
                             f"driver's final test {test}")

    # resume from 'last' (step 8, epoch 2) with --epochs 3: the state right
    # after the restore is the file's; then the run goes on to its end
    rcfg = parse_config(DRIVER_ARGV + ["--resume", "last", "--epochs", "3"])
    pay = ckpt.load_checkpoint(last)
    tr = Trainer(rcfg, get_model(rcfg), dev, eval_only=False,
                 iters_per_epoch=per, seed=rcfg.seed, txt_table=table)
    log = Logger(rcfg)
    start, it, path = train_drv.restore_for_resume(rcfg, 0, tr, log)
    log.close()
    if (start, it, path, tr.step) != (2, n_train, last, n_train) \
            or tr.current_lr() != lrs[n_train]:
        raise AssertionError(f"drivers resume: {start} {it} {path} "
                             f"{tr.step} lr {tr.current_lr()} vs "
                             f"{lrs[n_train]}")
    _state_equal("resume", tr.state_dicts(),
                 (pay["model"], pay["optimizer"]))
    del tr
    gc_collect()
    _, rtest = train_drv.run_fold(rcfg, 0, *loaders, txt_table=table)
    events = _events(os.path.join(root, "logs_0", "events.jsonl"))
    steps = [e["step"] for e in events if e["tag"] == "val/loss"]
    if steps != [4, 8, 12, 16] or rtest is None:
        raise AssertionError(f"drivers resume: validation at {steps}, test "
                             f"{rtest}")
    print(f"drivers resume: restored step {n_train} bit for bit (lr "
          f"{lrs[n_train]:.6g}), ran to step 16, test {rtest}")
    gc_collect()
    print(f"drivers phase ({power}): {time.perf_counter() - t_phase:.1f} s")


# phase 15: --remat 1 against --remat 0 (one fp32 step at dropout 0.1,
# every gradient by Frobenius ratio), and config 1 through the drivers
REMAT_TOL = 1e-6
BASE_DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "baseline_driver_smoke")
BASE_DRIVER_BATCHES = {"train": 4, "val": 2, "test": 2}
BASE_PATHS = {"config1": "unimodal_transformer config 1 train",
              "base2": "bi_vslttxt_mbt_v1 config 2 train",
              "base3": "bi_vsltimg_mbt_v1 config 3 train",
              "tri_v1": "tri_mbt_v1 config 4 train"}


def _remat_step(cfg, state, batch, remat: int):
    """One train step from ``state`` at ``--remat``: (loss, gradients of
    the trainable parameters, peak device memory, launches)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    c = cfg.replace(remat=remat)
    model = get_model(c, torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    tr = Trainer(c, model, torch.device("cuda"), eval_only=False, seed=0)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    loss = tr.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {k: v for k, v in ops.launches.items() if v}
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {names[id(p)]: p.grad.double().clone()
             for p in tr.optimizer.params}
    del tr, model
    gc_collect()
    return loss, grads, peak, counts


def _check_remat(cfg, state, batch, power: str) -> None:
    """--remat 1 recomputes each layer's forward in the backward with the
    seeds it drew first: fp32 gradients within REMAT_TOL (relative
    Frobenius) of --remat 0's at dropout 0.1, the loss equal; the peak
    memory of both, fp32 and bf16; bf16 ms/step of both in turns."""
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    out = {}
    for prec in ("fp32", "bf16"):
        c = cfg.replace(precision=prec, dropout=0.1)
        for remat in (0, 1):
            out[prec, remat] = _remat_step(c, state, batch, remat)
    (l0, g0, _, n0), (l1, g1, _, n1) = out["fp32", 0], out["fp32", 1]
    errs = {n: float((g1[n] - g).norm() / g.norm().clamp_min(1e-30))
            for n, g in g0.items()}
    worst = max(errs, key=errs.get)
    print(f"config1 remat fp32 dropout 0.1: loss {l1:.7f} vs {l0:.7f}; "
          f"grads |remat 1 - remat 0|_F/|remat 0|_F max {errs[worst]:.3e} "
          f"({worst}) over {len(errs)} tensors; launches remat 0 {n0}, "
          f"remat 1 {n1}")
    for prec in ("fp32", "bf16"):
        p0, p1 = out[prec, 0][2], out[prec, 1][2]
        print(f"config1 remat peak device memory {prec} ({power}): remat 0 "
              f"{p0 / 2 ** 30:.3f} GiB, remat 1 {p1 / 2 ** 30:.3f} GiB "
              f"({100 * (1 - p1 / p0):.1f} % less)")
    if l1 != l0 or errs[worst] > REMAT_TOL or n1["attn_block"] != \
            2 * n0["attn_block"]:
        raise AssertionError("config1: --remat 1 differs from --remat 0")
    # bf16 train ms/step at --remat 0 and 1, in turns (0, 1, 1, 0)
    trainers = {}
    for remat in (0, 1):
        c = cfg.replace(remat=remat)
        model = get_model(c, torch.Generator().manual_seed(0))
        model.load_state_dict(state)
        trainers[remat] = Trainer(c, model, torch.device("cuda"),
                                  eval_only=False, seed=0)
        trainers[remat].train_step(batch)
    ms = {0: [], 1: []}
    for remat in (0, 1, 1, 0):
        ms[remat].append(_timed_train_ms(trainers[remat], [batch] * 3,
                                         False))
    print(f"config1 remat bf16 train step ({power}): remat 0 "
          f"{np.mean(ms[0]):.2f} ms/step, remat 1 {np.mean(ms[1]):.2f} "
          f"ms/step ({np.mean(ms[1]) / np.mean(ms[0]):.3f}x); rounds "
          f"{ms[0]} / {ms[1]}")
    del trainers, model
    gc_collect()


def _driver_run(name: str, argv, batches: dict, power: str) -> None:
    """One fold of ``argv`` through the train driver (1 epoch of
    ``batches`` train, val and test batches, bf16, dropout 0.1) with its
    launch counts, then the test driver's walk to the same test metrics."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
        BatchList, synthetic_batch)
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.logger import \
        make_setting_file

    root = os.path.join(BASE_DRIVER_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    # --img-pack-frac: the driver resolves -1 from the real loader's
    # sampler, which synthetic loaders lack
    cfg = parse_config(argv + ["--epochs", "1", "--log-iter", "1",
                               "--img-pack-frac", "0.5",
                               "--dir-result", root, "--project-name", name])
    loaders, seed = {}, 300
    for split, n in batches.items():
        loaders[split] = BatchList([synthetic_batch(cfg, BATCH, seed=seed + i)
                                    for i in range(n)])
        seed += n
    make_setting_file(cfg)
    gc_collect()
    ops.reset_launches()
    t0 = time.perf_counter()
    val, test = train_drv.run_fold(cfg, 0, loaders["train"], loaders["val"],
                                   loaders["test"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(ops.launches)
    n_train = batches["train"]
    n_eval = batches["val"] + batches["test"]
    print(f"{name} drivers: launches over {n_train} train and {n_eval} eval "
          f"steps: {counts}; val {val}; test {test}; run {run_s:.2f} s "
          f"({power})")
    for kernel in ops.KERNELS:
        want = (n_train * TRAIN_LAUNCHES_PER_STEP[name].get(kernel, 0)
                + n_eval * LAUNCHES_PER_STEP[name].get(kernel, 0))
        if counts[kernel] != want:
            raise AssertionError(f"{name} drivers {kernel}: "
                                 f"{counts[kernel]} launches, expected "
                                 f"{want}")
    if test is None or not np.isfinite(test["apr"]):
        raise AssertionError(f"{name} drivers: test metrics {test}")
    best = ckpt.ckpt_path(root, cfg.project_name, "best", 0, cfg.seed)
    walked = test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                      loaders["test"])
    got = dict(walked).get(best)
    print(f"{name} test driver: {[(os.path.basename(p), m['auc'], m['apr']) for p, m in walked]}")
    if got != test:
        raise AssertionError(f"{name}: test driver {got} vs the train "
                             f"driver's final test {test}")
    gc_collect()


def run_baseline(power: str) -> dict:
    """Phase 15: the BASELINE configs' own models at full width. Config 1
    (unimodal_transformer, TIE): eval and train as phases 4 and 7 (timed,
    profiled, 20 steps, one step on both paths at dropout 0 and 0.1),
    --remat 1 against --remat 0, QIE and carryforward eval, the drivers;
    configs 2 and 3 (bi_vslttxt_mbt_v1, bi_vsltimg_mbt_v1) and
    tri_mbt_v1: eval against the plain path in bf16 and fp32, one train
    step on both paths, launch counts. Returns each train path's
    launches."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model

    t_phase = time.perf_counter()
    run_config("config1", CONFIG1, power, timed=True)
    counts = {"config1": run_train("config1", CONFIG1, power, timed=True)}
    cfg = parse_config(CONFIG1)
    state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    _check_remat(cfg, state, synthetic_batch(cfg, BATCH, seed=10), power)
    del state
    for vslt in ("QIE", "carryforward"):
        name = "config1_qie" if vslt == "QIE" else "config1_cf"
        run_config(name, [a if a != "TIE" else vslt for a in CONFIG1],
                   power, timed=False)
    _driver_run("config1", CONFIG1, BASE_DRIVER_BATCHES, power)
    for name, argv in (("base2", BASE2), ("base3", BASE3),
                       ("tri_v1", TRI_V1)):
        run_config(name, argv, power, timed=False)
        counts[name] = run_train(name, argv, power, timed=False)
    print(f"baseline phase ({power}): {time.perf_counter() - t_phase:.1f} s")
    return counts


# phase 16, the multitoken MBT family on config 4's flags (one CXR per
# sample, the trunk over all 64 rows: the family runs it unpacked, as the
# JAX package does): tri_mbt_vmulti (4/2/2 cls tokens, four bottleneck
# groups), tri_mbt_vmulti2 (its head over the VSLTMAIN fusion) and
# tri_mbt_vmultivslt (the vslt stream's four cls tokens). Every fusion
# layer runs the attention block under its stream's 3-D block mask
# (attn_block_3d) and the FFN over every row. Per eval step: umse 1,
# attn_block_3d 18, ffn 18, swin 12 / 12; per train step also umse_bwd 1,
# the input dropout's masks 3 and a backward per layer whose output the
# loss reaches: every one (18) where the head reads each stream's tokens,
# 16 for tri_mbt_vmultivslt, whose last img and txt layers feed only the
# group mix that nothing reads after the last layer
MULTI_ARGV = {name: [a if a != "tri_mbt_vsltcls" else model for a in CONFIG4]
              for name, model in (("vmulti", "tri_mbt_vmulti"),
                                  ("vmulti2", "tri_mbt_vmulti2"),
                                  ("vmultivslt", "tri_mbt_vmultivslt"))}
MULTI_EVAL = {"umse": 1, "attn_block_3d": 18, "ffn": 18,
              "swin_attention": 12, "swin_mlp": 12}
for _name in MULTI_ARGV:
    _bwd = 16 if _name == "vmultivslt" else 18
    LAUNCHES_PER_STEP[_name] = MULTI_EVAL
    TRAIN_LAUNCHES_PER_STEP[_name] = dict(
        MULTI_EVAL, umse_bwd=1, attn_block_3d_bwd=_bwd, ffn_bwd=_bwd,
        dropout_masks=3)
    BATCHES[_name] = [0.5, 0.25, 0.75] if _name == "vmulti" else [0.5, 0.75]
    TRAIN_BATCHES[_name] = ([0.5, 0.25, 0.75] if _name == "vmulti"
                            else [0.5])
MULTI_DRIVER_BATCHES = {"train": 2, "val": 1, "test": 1}
MULTI_PATHS = {"vmulti": "tri_mbt_vmulti train",
               "vmulti2": "tri_mbt_vmulti2 train",
               "vmultivslt": "tri_mbt_vmultivslt train"}
# the kernel phase's cases: (tag, stream, content rows, VSLTMAIN) at full
# width, [64, cls + rows + 12, 256]: the vslt stream (4 cls + 1000 TIE
# rows), the img stream (2 cls + 49) and the txt stream (2 cls + 128 note
# rows), and the VSLTMAIN img and txt streams (no cls)
BLOCK_SHAPES = (("vslt", 0, TIE_LEN, False), ("img", 1, 49, False),
                ("txt", 2, 128, False), ("img_main", 1, 49, True),
                ("txt_main", 2, 128, True))
# the kernels of each attn_block route (kernels/attn_block.py route)
BLOCK_ROUTE_KERNELS = {
    "tc": (("block_qkv_tc_kernel", "block_attn_tc_kernel"),
           ("block_delta_kernel", "block_dkv_tc_kernel", "block_dq_tc_kernel",
            "block_ln_bwd_tc_kernel")),
    "fma": (("proj_kernel", "attn_kernel"),
            ("dkv_kernel", "dq_kernel", "ln_bwd_kernel"))}


def _stream_block_mask(g, dev, stream: int, rows: int, vslt_main: bool):
    """The fusion's block mask of one stream (models/mbt.py::
    block_key_mask) over seeded lengths as the model computes them: TIE
    lengths in [1, 1000] (cls included), the image stream at its full
    length, note lengths in [1, 126] plus the 2 BOS/EOS rows with samples
    3 and 5 without a note (under the 16 x 16 pattern their rows 14-15
    then have every key masked); ``vlen == 3 -> 0`` on the txt stream."""
    from medical_tri_modal_pilot_tpu_torch.models.mbt import block_key_mask
    cls = 4 if stream == 0 else (0 if vslt_main else 2)
    if stream == 0:
        vlen = torch.randint(1, rows + 1, (BATCH,), generator=g)
    elif stream == 1:
        vlen = torch.full((BATCH,), rows)
    else:
        vlen = torch.randint(1, rows - 1, (BATCH,), generator=g)
        vlen[3] = vlen[5] = 0
        vlen = vlen + 2
    vlen = vlen + cls
    if stream == 2:
        vlen = torch.where(vlen == 3, 0, vlen)
    return block_key_mask(vlen.to(dev), cls + rows, 4, stream, vslt_main)


def compare_block_mask_kernels() -> dict:
    """The attention block under the multitoken streams' 3-D block masks
    (BLOCK_SHAPES) against its plain version, fp32 (the FMA route) and
    bf16 (the tensor cores): the lean form (every row), the training form
    and the backward (every gradient by Frobenius ratio in float64), the
    rows whose every key is masked included; CUDA-event ms beside the
    plain version's and the bound, then the profiler's device ms per form
    and the launched kernels (the dtype's route's, in their block-mask
    instantiations). Returns the bf16 results at the vslt shape."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
        TILE_DEAD, TILE_FULL, attn_block_route, block_tile_map,
        cuda_block_tile_map)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(16)
    bf16 = torch.bfloat16
    D, H = 256, 4

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results = {}
    for tag, stream, rows, vslt_main in BLOCK_SHAPES:
        mask = _stream_block_mask(g, dev, stream, rows, vslt_main)
        Lb = mask.shape[1]
        dead = int(mask.all(dim=-1).sum())
        print(f"attn_block_3d {tag}: mask [{BATCH},{Lb},{Lb}], "
              f"{float(mask.float().mean()):.3f} of the pairs masked, "
              f"{dead} rows with every key masked")
        if tag == "txt" and not dead:
            raise AssertionError("the txt stream's mask has no fully "
                                 "masked row")
        # the tile map the bf16 loops skip by: the card's against the
        # plain version, bit for bit
        tmap = cuda_block_tile_map(mask.view(torch.int8))
        if not torch.equal(tmap, block_tile_map(mask)):
            raise AssertionError(f"attn_block_3d {tag}: the tile map "
                                 "differs from block_tile_map")
        n_tiles = tmap.numel()
        # built in each call of the bf16 forms (kernels/attn_block.py), so
        # their per-call times below include it
        map_ms = _device_ms(lambda: cuda_block_tile_map(
            mask.view(torch.int8)), expect=("block_tile_map_kernel",))[0]
        print(f"attn_block_3d {tag}: tile map {tuple(tmap.shape)}, "
              f"{int((tmap == TILE_DEAD).sum()) / n_tiles:.3f} dead, "
              f"{int((tmap == TILE_FULL).sum()) / n_tiles:.3f} full, the "
              f"rest mixed; block_tile_map_kernel {map_ms:.4f} ms device, "
              "once a bf16 call ("
              + ("used" if Lb > 64 else "not used: one key tile") + ")")
        # the keys each sample needs (the bound counts these; the kernel,
        # as the TPU kernel, runs all Lb): up to the last key any row
        # leaves unmasked, or all Lb where some row has every key masked
        # (it attends uniformly over them)
        open_keys = (~mask.bool()).any(dim=1)
        last = torch.where(open_keys, torch.arange(1, Lb + 1, device=dev),
                           0).amax(dim=1)
        kext = torch.where(mask.bool().all(dim=-1).any(dim=-1), Lb,
                           last).double()
        print(f"attn_block_3d {tag}: keys the bound counts per sample, "
              f"mean {float(kext.mean()):.1f} of {Lb}")
        # per sample: the q projection of every row and the k|v projection
        # of the kext keys; the attention products of every row over them
        fwd_flops = float((2 * Lb * D * D + 4 * kext * D * D
                           + 4 * Lb * kext * D).sum())
        # the backward: the projections' recompute, dx and dW (3x), the
        # five attention products (S, dP, dV, dK, dQ)
        bwd_flops = float((3 * (2 * Lb * D * D + 4 * kext * D * D)
                           + 10 * Lb * kext * D).sum())
        gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
        w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
        fwd = lambda *a: ops.attn_block(*a, mask, (D // H) ** .5, H)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xa = rnd(BATCH, Lb, D).to(dt)
            wd, bd = w.to(dt), b.to(dt)
            stream_bytes = BATCH * Lb * D * es
            work = (2 * stream_bytes + _nbytes(wd, bd, gamma, beta, mask),
                    fwd_flops)
            name = f"attn_block_3d[{BATCH},{Lb},{D}] {tag}"
            with torch.inference_mode():
                lean = _compare(name, dt, lambda: fwd(xa, gamma, beta, wd,
                                                      bd), work)
            cot = rnd(BATCH, Lb, D).to(dt)
            work_f = (3 * stream_bytes + 8 * BATCH * H * Lb
                      + _nbytes(wd, bd, gamma, beta, mask), fwd_flops)
            work_b = (4 * stream_bytes + 8 * BATCH * H * Lb
                      + (3 * D * D + 3 * D) * (es + 4) + _nbytes(mask),
                      bwd_flops)
            fr, br = _compare_train(name, dt, fwd, (xa, gamma, beta, wd, bd),
                                    cot, None, work_f, work_b)
            route = attn_block_route(dt, D, H)
            dev_ms = _device_forms(name, dt, fwd, (xa, gamma, beta, wd, bd),
                                   cot, None, BLOCK_ROUTE_KERNELS, route)
            # the forward's attention kernel in its block-mask form
            form = "BlockMask" if route == "tc" else ", true>"
            if not any(form in n for n in dev_ms["names"]
                       if "attn_kernel" in n or "block_attn_tc" in n):
                raise AssertionError(f"{name}: no block-mask instantiation "
                                     f"launched: {dev_ms['names']}")
            if tag == "vslt" and dt == bf16:
                fr["device_ms"], br["device_ms"] = (dev_ms["train"],
                                                    dev_ms["bwd"])
                _print_earlier(f"{name} training forward", fr,
                               EARLIER_MS["attn_block_3d"])
                _print_earlier(f"{name} backward", br,
                               EARLIER_MS["attn_block_3d_bwd"])
                # the 2-D key-mask form at the same shape, its keys those
                # every query masks, in the same call
                keys = mask.bool().all(dim=1)
                fwd2 = lambda *a: ops.attn_block(*a, keys, (D // H) ** .5, H)
                two = _device_forms(f"attn_block[{BATCH},{Lb},{D}] key mask",
                                    dt, fwd2, (xa, gamma, beta, wd, bd), cot,
                                    None, ATTN_BLOCK_ROUTE_KERNELS, route)
                print(f"{name}: 3-D over 2-D key-mask device time, "
                      f"training {dev_ms['train'] / two['train']:.3f}, "
                      f"backward {dev_ms['bwd'] / two['bwd']:.3f}")
                results["attn_block_3d"] = dict(
                    lean, shape=f"[{BATCH},{Lb},{D}]", train_ms=fr["ms"],
                    train_plain_ms=fr["plain_ms"],
                    train_bound_ms=fr["bound_ms"],
                    device_ms=dev_ms["lean"], train_device_ms=dev_ms["train"])
                results["attn_block_3d_bwd"] = dict(
                    br, shape=f"[{BATCH},{Lb},{D}]",
                    device_ms=dev_ms["bwd"])
        del mask
        gc_collect()
    return results


def _check_case_probs(name: str, argv) -> None:
    """Every head's probabilities, the model's [4, B] logits through the
    sigmoid, on the kernel path against the plain path on one batch, bf16
    and fp32 (PROB_TOL)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import (
        Trainer, compute_missing_num)
    cfg = parse_config(argv)
    batch = synthetic_batch(cfg, BATCH, seed=0, present_frac=0.5)
    for prec in ("bf16", "fp32"):
        c = cfg.replace(precision=prec)
        tr = Trainer(c, get_model(c, torch.Generator().manual_seed(0)),
                     torch.device("cuda"))
        with torch.inference_mode():
            b = tr.device_batch(batch)
            mn = compute_missing_num(c, b["missing"])
            got = torch.sigmoid(tr.model(b, mn)[0].float())
            with ops.reference_path():
                want = torch.sigmoid(tr.model(b, mn)[0].float())
        err = float((got - want).abs().max())
        print(f"{name} {prec}: [4, {BATCH}] head probabilities, max |kernel "
              f"- plain| = {err:.3e} (tol {PROB_TOL[prec]})")
        if got.shape != (4, BATCH) or not err <= PROB_TOL[prec]:
            raise AssertionError(f"{name} {prec}: the heads disagree with "
                                 "the plain path")
        del tr
        gc_collect()


def run_multitoken(power: str):
    """Phase 16: the 3-D block-mask kernels (compare_block_mask_kernels),
    then tri_mbt_vmulti, tri_mbt_vmulti2 and tri_mbt_vmultivslt at full
    width: eval against the plain path (the selected probabilities, bf16
    and fp32, and every head's), one train step on both paths in fp32 and
    bf16 at dropout 0 and 0.1, launch counts; tri_mbt_vmulti also timed
    in turns (eval and train), profiled, its peak memory, 20 steps on one
    batch, and a fold through the train and test drivers. Returns (the
    kernel results, each train path's launches)."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    t_phase = time.perf_counter()
    results = compare_block_mask_kernels()
    counts = {}
    for name, argv in MULTI_ARGV.items():
        if parse_config(argv).mbt_bottlenecks_n != 4:
            raise AssertionError(f"{name}: --mbt-bottlenecks-n changed")
        timed = name == "vmulti"
        run_config(name, argv, power, timed=timed)
        _check_case_probs(name, argv)
        counts[name] = run_train(name, argv, power, timed=timed,
                                 all_parity=True)
        gc_collect()
    _driver_run("vmulti", MULTI_ARGV["vmulti"], MULTI_DRIVER_BATCHES, power)
    if "config4" in TRAIN_STEP_MS:
        print(f"multitoken train step ({power}): tri_mbt_vmulti "
              f"{TRAIN_STEP_MS['vmulti']:.2f} ms/step, config 4 (phase 7, "
              f"this call) {TRAIN_STEP_MS['config4']:.2f} ms/step, "
              f"{TRAIN_STEP_MS['vmulti'] / TRAIN_STEP_MS['config4']:.2f}x")
    print(f"multitoken phase ({power}): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return results, counts


# phase 18, the rest of the paper's MBT registry on config 4's
# flags, the model swapped (the bimodal names on their own --input-types):
# tri_mbt_vsltcls_noshareumse (stems per stream; umse still once, on the
# vslt stem), tri_mbt_vflexible / 2 / 3 (learned missing-aware weights of
# per-stream logits), tri_mbt_vnoshavgtr / vnoshnoavgtr (a BatchNorm head
# per stream) and the concat fusion *_mt_v1 (the trunk over all 64 rows,
# the joint stream [64, 1 + 1000 + 50 + 128, 256] unpadded, its FFN over
# every row). Per eval step the MBT ablations launch as config 4; the
# concat fusion umse 1, one attn_block and one ffn per joint layer (6),
# swin 12 / 12 with images. Per train step the heads that read every
# stream's cls token (vflexible, vnosh) give the last layer's img and txt
# streams their backward (18 / 18; noshareumse 16 / 16, as config 4); the
# concat fusion's 6 joint layers get theirs; one input-dropout mask per
# stream
REGISTRY = {"noshare": ("tri_mbt_vsltcls_noshareumse", "vslt_img_txt"),
            "vflex": ("tri_mbt_vflexible", "vslt_img_txt"),
            "vflex2": ("tri_mbt_vflexible2", "vslt_img_txt"),
            "vflex3": ("tri_mbt_vflexible3", "vslt_img_txt"),
            "vnoshavg": ("tri_mbt_vnoshavgtr", "vslt_img_txt"),
            "vnoshnoavg": ("tri_mbt_vnoshnoavgtr", "vslt_img_txt"),
            "tri_mt": ("tri_mt_v1", "vslt_img_txt"),
            "mt_v1": ("mt_v1", "vslt_img_txt"),
            "biimg_mt": ("biimg_mt_v1", "vslt_img"),
            "bitxt_mt": ("bitxt_mt_v1", "vslt_txt")}
REGISTRY_ARGV = {
    name: [{"tri_mbt_vsltcls": model, "vslt_img_txt": inputs}.get(a, a)
           for a in CONFIG4]
    for name, (model, inputs) in REGISTRY.items()}
# timed and profiled as phase 15 times config 1
REGISTRY_TIMED = ("vflex", "tri_mt")
# the JAX model of these raises on two streams; the port refuses them
REGISTRY_REFUSED = {"biimg_mbt_vflexible1": "vslt_img",
                    "bitxt_mbt_vflexible1": "vslt_txt"}
for _name, (_model, _inputs) in REGISTRY.items():
    _timed = _name in REGISTRY_TIMED
    BATCHES[_name] = [0.5, 0.25, 0.75] if _timed else [0.5, 0.75]
    TRAIN_BATCHES[_name] = [0.5, 0.25, 0.75] if _timed else [0.5]
    if "mt_v1" not in _model:
        LAUNCHES_PER_STEP[_name] = LAUNCHES_PER_STEP["config4"]
        TRAIN_LAUNCHES_PER_STEP[_name] = TRAIN_LAUNCHES_PER_STEP[
            "config4" if _name == "noshare" else "tri_v1"]
        continue
    _swin = ({"swin_attention": 12, "swin_mlp": 12} if "img" in _inputs
             else {})
    LAUNCHES_PER_STEP[_name] = dict(umse=1, attn_block=6, ffn=6, **_swin)
    TRAIN_LAUNCHES_PER_STEP[_name] = dict(
        LAUNCHES_PER_STEP[_name], umse_bwd=1, attn_block_bwd=6, ffn_bwd=6,
        dropout_masks=len(_inputs.split("_")))
REGISTRY_PATHS = {name: f"{model} train"
                  for name, (model, _) in REGISTRY.items()}
# --model-types classification: tri_mbt_vsltcls on config 4's flags, each
# --loss-types at the output width the JAX package's test runs it at (12
# hour buckets; a time to the event), launching as config 4
CLS_LOSSES = {"softmax": 12, "bces": 12, "bceandsoftmax": 12, "rmse": 1,
              "bce": 1}
CLS_ARGV = {loss: CONFIG4 + ["--model-types", "classification",
                             "--loss-types", loss, "--output-dim", str(dim)]
            for loss, dim in CLS_LOSSES.items()}
for _loss in CLS_LOSSES:
    LAUNCHES_PER_STEP["cls_" + _loss] = LAUNCHES_PER_STEP["config4"]
    BATCHES["cls_" + _loss] = [0.5, 0.75]
CLS_DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "classification_driver_smoke")
CLS_DRIVER_BATCHES = {"train": [0.5, 0.75], "val": [0.5], "test": [0.25]}


# the concat fusion's joint stream at config 4's shapes: the final cls
# token, 1000 TIE rows, the image cls token and 49 image rows, 128 note
# rows: not a multiple of 64, so the FFN skips no row tile
MT_JOINT = 1 + TIE_LEN + 50 + 128


def compare_joint_kernels() -> dict:
    """attn_block (training forward and backward) and the ffn (dropout
    0.1, training and backward) at the concat fusion's joint shape
    [64, 1179, 256] under its key mask (the cls and image rows never
    masked, the vslt and note rows past their sample's lengths, one
    sample's note masked whole), fp32 and bf16, against autograd of the
    plain versions, in bf16 with the profiler's device ms per form and the
    launched kernels (_train_forms: TOL on live rows, GRAD_TOL, the
    dtype's route; fp32 against the plain versions only), event and
    plain ms, the bound. Returns the bf16 results by kernel name."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
        attn_block_route, key_ends)
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import ffn_route
    from medical_tri_modal_pilot_tpu_torch.models.modules import \
        length_key_mask
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(18)
    D, H, F, P, L = 256, 4, 1024, 0.1, MT_JOINT

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    vslt = torch.randint(5, TIE_LEN + 1, (BATCH,), generator=g)
    txt = torch.randint(1, 129, (BATCH,), generator=g) + 1
    txt[3] = 2                                   # vlen 2 -> 0: masked whole
    txt = torch.where(txt == 2, 0, txt)
    mask = torch.cat([torch.zeros(BATCH, 1, dtype=torch.bool),
                      length_key_mask(vslt, TIE_LEN),
                      torch.zeros(BATCH, 50, dtype=torch.bool),
                      length_key_mask(txt, 128)], 1).to(dev)
    ends = key_ends(mask).long()
    live = torch.arange(L, device=dev)[None, :] < ends[:, None]
    n = ends.double()
    rows = BATCH * L
    gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
    w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
    g1, be1 = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
    w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
    w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        es = 2 if dt == torch.bfloat16 else 4
        x = rnd(BATCH, L, D).to(dt)
        wbytes = (2 * D * F + F + D) * 4
        cases = [
            (f"attn_block[64,{L},256] mt joint",
             lambda *a: ops.attn_block(*a, mask, (D // H) ** .5, H),
             (x, gamma, beta, w.to(dt), b.to(dt)),
             rnd(BATCH, L, D).to(dt) * live[:, :, None], live,
             *_attn_block_work(L, D, H, es, n),
             ATTN_BLOCK_ROUTE_KERNELS, attn_block_route(dt, D, H)),
            (f"ffn[{rows},256] mt joint dropout {P}",
             lambda *a: ops.ffn(*a, None, p=P, training=True,
                                seed=DROPOUT_SEED),
             (x, g1, be1, w1, b1, w2, b2), rnd(BATCH, L, D).to(dt), None,
             (2 * rows * D * es + wbytes, 4.0 * rows * D * F),
             (3 * rows * D * es + 2 * wbytes, 10.0 * rows * D * F),
             FFN_ROUTE_KERNELS, ffn_route(dt, D))]
        res = []
        for tag, fwd, inputs, cot, lv, work_f, work_b, routes, route in cases:
            if dt == torch.bfloat16:
                res.append(_train_forms(tag, dt, fwd, inputs, cot, lv,
                                        work_f, work_b, routes, route,
                                        lean=False))
                continue
            # fp32, the checking dtype: against the plain version only (its
            # FMA kernels' device ms are no main-path figure, and the
            # profiler drops the records of the fp32 ffn here, 20
            # sessions in a row)
            _compare_train(tag, dt, fwd, inputs, cot, lv, work_f, work_b)
        if dt == torch.bfloat16:
            (_, fr, br), (_, fr2, br2) = res
            # keyed by the kernels line's names; the forwards' training
            # forms
            shape = f"[64,{L},256]"
            results = {"attn_block": dict(fr, shape=shape, form="training"),
                       "attn_block_bwd": dict(br, shape=shape),
                       "ffn": dict(fr2, shape=f"[{rows},256]",
                                   form="training"),
                       "ffn_bwd": dict(br2, shape=f"[{rows},256]")}
    return results


def _classification_run(power: str) -> None:
    """--model-types classification: each --loss-types' eval against the
    plain path (bf16 and fp32 probabilities, launch counts) and one train
    step on both paths (fp32 and bf16, dropout 0.1, phase 7's gates); then
    bceandsoftmax through the train driver's fold over wire batches (1
    epoch of 2 train, 1 val, 1 test) with its launch counts, and the test
    driver's walk to its final test metrics."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
        BatchList, synthetic_batch)
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.logger import \
        make_setting_file

    for loss, argv in CLS_ARGV.items():
        name = "cls_" + loss
        run_config(name, argv, power, timed=False)
        cfg = parse_config(argv)
        state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
        batch = synthetic_batch(cfg, BATCH, seed=10, present_frac=0.5)
        _check_step_parity(name, cfg, state, batch,
                           [("fp32", 0.1), ("bf16", 0.1)])
        gc_collect()

    shutil.rmtree(CLS_DRIVER_DIR, ignore_errors=True)
    cfg = parse_config(CLS_ARGV["bceandsoftmax"] + [
        "--epochs", "1", "--log-iter", "1", "--img-pack-frac", "0.55",
        "--dir-result", CLS_DRIVER_DIR, "--project-name", "classification"])
    wire, _, table = _driver_loaders(cfg, CLS_DRIVER_BATCHES)
    loaders = {k: BatchList(v) for k, v in wire.items()}
    make_setting_file(cfg)
    gc_collect()
    ops.reset_launches()
    val, test = train_drv.run_fold(cfg, 0, loaders["train"], loaders["val"],
                                   loaders["test"], txt_table=table)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    n_train = len(CLS_DRIVER_BATCHES["train"])
    n_eval = len(CLS_DRIVER_BATCHES["val"]) + len(CLS_DRIVER_BATCHES["test"])
    print(f"classification bceandsoftmax drivers: launches over {n_train} "
          f"train and {n_eval} eval steps: {counts}; val {val}; test {test}")
    for kernel in ops.KERNELS:
        want = (n_train * TRAIN_LAUNCHES_PER_STEP["config4"].get(kernel, 0)
                + n_eval * LAUNCHES_PER_STEP["config4"].get(kernel, 0))
        if counts[kernel] != want:
            raise AssertionError(f"classification drivers {kernel}: "
                                 f"{counts[kernel]} launches, expected "
                                 f"{want}")
    if test is None or not all(np.isfinite(test[k])
                               for k in ("auc", "apr", "f1")):
        raise AssertionError(f"classification drivers: test metrics {test}")
    best = ckpt.ckpt_path(CLS_DRIVER_DIR, cfg.project_name, "best", 0,
                          cfg.seed)
    walked = dict(test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                           loaders["test"], txt_table=table))
    print(f"classification test driver: {walked.get(best)}")
    if walked.get(best) != test:
        raise AssertionError(f"classification: test driver "
                             f"{walked.get(best)} vs the train driver's "
                             f"final test {test}")
    gc_collect()


# tri_mbt_vflexible*'s learned weights start at zero, where every
# temperature gives the same uniform softmax; phase 18 sets them to these,
# so that each name's temperature shapes its weights
FLEX_WEIGHTS = ((0.5,), (-0.3,), (0.8,))


@contextlib.contextmanager
def _flex_weights():
    """get_model, while this runs, builds tri_mbt_vflexible* with
    ``flexibleavg`` = FLEX_WEIGHTS (every model run_config, run_train and
    _train_run build for them)."""
    from medical_tri_modal_pilot_tpu_torch import models
    build = models.get_model

    def get_model(cfg, generator=None, state=None):
        model = build(cfg, generator, state)
        if hasattr(model, "flexibleavg"):
            with torch.no_grad():
                model.flexibleavg.copy_(torch.tensor(FLEX_WEIGHTS))
        return model

    models.get_model = get_model
    try:
        yield
    finally:
        models.get_model = build


def run_registry(power: str) -> dict:
    """Phase 18: the rest of the paper's MBT registry at full width, bf16,
    on config 4's flags: each name's eval against the plain path (bf16 and
    fp32), one train step on both paths in fp32 and bf16 at dropout 0 and
    0.1, launch counts (tri_mbt_vflexible*'s learned weights set to
    FLEX_WEIGHTS); tri_mbt_vflexible and tri_mt_v1 also timed in
    turns, profiled (device busy and idle share), their peak memory and 20
    steps on one batch; the bimodal *_mbt_vflexible1 names refused; then
    --model-types classification (_classification_run). First the
    kernels at the concat fusion's joint shape (compare_joint_kernels).
    Returns (those kernel results, each train path's launches)."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    t_phase = time.perf_counter()
    results = compare_joint_kernels()
    counts = {}
    for name, argv in REGISTRY_ARGV.items():
        timed = name in REGISTRY_TIMED
        with _flex_weights():
            run_config(name, argv, power, timed=timed)
            counts[name] = run_train(name, argv, power, timed=timed,
                                     all_parity=True)
        gc_collect()
    for model, inputs in REGISTRY_REFUSED.items():
        argv = [{"tri_mbt_vsltcls": model, "vslt_img_txt": inputs}.get(a, a)
                for a in CONFIG4]
        try:
            get_model(parse_config(argv))
        except ValueError as e:
            print(f"{model}: refused, {e}")
        else:
            raise AssertionError(f"{model} on {inputs}: not refused")
    _classification_run(power)
    if "config4" in TRAIN_STEP_MS:
        print("registry train step (" + power + "): " + ", ".join(
            f"{REGISTRY[n][0]} {TRAIN_STEP_MS[n]:.2f} ms/step"
            for n in REGISTRY_TIMED) + f"; config 4 (phase 7, this call) "
            f"{TRAIN_STEP_MS['config4']:.2f} ms/step")
    print(f"registry phase ({power}): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return results, counts


# phase 19, the paper's baselines and the trainable trunk at full width,
# bf16: gru_d, lstm and feature_temporal_v1 on the carryforward grid (T
# 24, 16 channels, the demographics), fusiontrainer (MedFuse, MMTM, DAFT:
# the two-layer EHR LSTM at d 256, the Swin-T trunk over all 64 images,
# trainable, the BioBERT notes' mean vector) on vslt_img_txt, tri_mbt_v2
# (the trunk trains) and tri_mbt_v3 (the patch stem, 196 image tokens) on
# config 4's flags, and the flagship at --img-pretrain No. Per eval step:
# no kernel for gru_d and lstm (plain recurrences, no TPU kernel either);
# feature_temporal_v1 an attn_block and an ffn per layer (2 instance
# layers unmasked on [64 x 24, 19, 256], 6 temporal ones on [64, 25,
# 256]); the trunk's 12 / 12 swin launches. Per train step: the input
# dropout's masks (one per stream, two for feature_temporal_v1), the
# fixed 0.3 dropout's of the LSTM features (lstm, MedFuse's EHR encoder,
# DAFT's head: one each; MMTM reads the sequence only), stochastic depth's
# two masks in each of the trunk's 11 dropping blocks (22), swin_mlp on
# block 0 only (the dropping blocks run the MLP branch unfused), and a
# backward per layer the loss reaches (every one where the head reads each
# stream's cls token); the trunk's backward launches the backward kernels
# (12 window attentions, 1 MLP; no plain recompute). --fusion-type uni_ehr
# stops the trunk's gradient: no backward kernel, the same masks
BL_FLAGS = ["--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--batch-size", str(BATCH)]
BL_CF = ["--input-types", "vslt", "--vslt-type", "carryforward"] + BL_FLAGS
BL_FT = (["--model", "fusiontrainer", "--input-types", "vslt_img_txt",
          "--vslt-type", "carryforward"] + BL_FLAGS)
BASELINES = {
    "gru_d": ["--model", "gru_d"] + BL_CF,
    "lstm": ["--model", "lstm"] + BL_CF,
    "ftv1": ["--model", "feature_temporal_v1"] + BL_CF,
    "ft_medfuse": BL_FT + ["--fuse-baseline", "Medfuse"],
    "ft_mmtm": BL_FT + ["--fuse-baseline", "MMTM"],
    "ft_daft": BL_FT + ["--fuse-baseline", "DAFT"],
    "v2": [a if a != "tri_mbt_vsltcls" else "tri_mbt_v2" for a in CONFIG4],
    "v3": [a if a != "tri_mbt_vsltcls" else "tri_mbt_v3" for a in CONFIG4],
    "pretrain_no": CONFIG4 + ["--img-pretrain", "No"]}
# train only (its eval is ft_medfuse's)
BL_UNI_EHR = BASELINES["ft_medfuse"] + ["--fusion-type", "uni_ehr"]
BL_TIMED = ("ft_medfuse", "v2")
BL_SWIN_EVAL = {"swin_attention": 12, "swin_mlp": 12}
BL_SWIN_TRAIN = {"swin_attention": 12, "swin_mlp": 1}
# the trunk's backward kernels a train step launches where it trains
BL_SWIN_BWD = {"swin_attention_bwd": 12, "swin_mlp_bwd": 1}
BL_SD_MASKS = 22
BL_V3_EVAL = {"umse": 1, "attn_block": 18, "ffn": 18}
LAUNCHES_PER_STEP.update(
    gru_d={}, lstm={}, gru_d_default={}, ftv1={"attn_block": 8, "ffn": 8},
    ft_medfuse=BL_SWIN_EVAL, ft_mmtm=BL_SWIN_EVAL, ft_daft=BL_SWIN_EVAL,
    v2=LAUNCHES_PER_STEP["config4"], v3=BL_V3_EVAL,
    pretrain_no=LAUNCHES_PER_STEP["config4"])
TRAIN_LAUNCHES_PER_STEP.update(
    gru_d={}, gru_d_default={}, lstm={"dropout_masks": 1},
    ftv1={"attn_block": 8, "attn_block_bwd": 8, "ffn": 8, "ffn_bwd": 8,
          "dropout_masks": 2},
    ft_medfuse=dict(BL_SWIN_TRAIN, dropout_masks=BL_SD_MASKS + 1,
                    **BL_SWIN_BWD),
    ft_mmtm=dict(BL_SWIN_TRAIN, dropout_masks=BL_SD_MASKS, **BL_SWIN_BWD),
    ft_daft=dict(BL_SWIN_TRAIN, dropout_masks=BL_SD_MASKS + 1,
                 **BL_SWIN_BWD),
    ft_uni=dict(BL_SWIN_TRAIN, dropout_masks=BL_SD_MASKS + 1),
    v2=dict(TRAIN_LAUNCHES_PER_STEP["tri_v1"], swin_mlp=1,
            dropout_masks=3 + BL_SD_MASKS, **BL_SWIN_BWD),
    v3=dict(BL_V3_EVAL, umse_bwd=1, attn_block_bwd=18, ffn_bwd=18,
            dropout_masks=3),
    pretrain_no=dict(TRAIN_LAUNCHES_PER_STEP["config4"], swin_mlp=1,
                     dropout_masks=3 + BL_SD_MASKS, **BL_SWIN_BWD))
for _name in list(BASELINES) + ["ft_uni", "gru_d_default"]:
    _timed = _name in BL_TIMED
    BATCHES[_name] = [0.5, 0.25, 0.75] if _timed else [0.5, 0.75]
    TRAIN_BATCHES[_name] = [0.5, 0.25, 0.75] if _timed else [0.5]
BL_PATHS = {"ftv1": "feature_temporal_v1 train",
            "ft_medfuse": "fusiontrainer Medfuse train",
            "ft_mmtm": "fusiontrainer MMTM train",
            "ft_daft": "fusiontrainer DAFT train",
            "ft_uni": "fusiontrainer Medfuse --fusion-type uni_ehr train",
            "v2": "tri_mbt_v2 train", "v3": "tri_mbt_v3 train",
            "pretrain_no": "tri_mbt_vsltcls --img-pretrain No train",
            "lstm": "lstm train"}
BL_DRIVER_BATCHES = {"train": 2, "val": 1, "test": 1}
# feature_temporal_v1's instance stream: cls + 16 channels + age + gender
FTV1_ROWS, FTV1_L = BATCH * 24, 19


def _swin_work(I: int, C: int, es: int) -> tuple:
    """(bytes, operations) of a window attention's training forward and of
    its backward over I windows of 49 tokens at width C: the forward's
    four products (q|k|v, scores, p v, the projection); the backward's
    eight (each product's two cotangents), reading x, the cotangent and
    the weights, writing dx and the fp32 weight and bias gradients."""
    N, nh = 49, C // 32
    tokens = I * N * C * es
    wts = (4 * C * C + 4 * C)
    ops_f = float(I * N * (8 * C * C + 4 * N * C))
    return ((2 * tokens + wts * es + nh * N * N * 4, ops_f),
            (3 * tokens + wts * (es + 4) + 2 * nh * N * N * 4, 2 * ops_f))


def _mlp_work(R: int, C: int, es: int) -> tuple:
    """(bytes, operations) of swin_mlp's training forward (two products
    of R x C x 4C) and backward (four), x read and y written once, the
    weights read (and their fp32 gradients written)."""
    F = 4 * C
    wts = 2 * C * F + F + 3 * C
    return ((2 * R * C * es + wts * es, 4.0 * R * C * F),
            (3 * R * C * es + wts * (es + 4), 8.0 * R * C * F))


def compare_swin_training() -> dict:
    """The trainable trunk's two ops at each Swin-T stage at batch 64
    (bf16, and fp32 at stage 1): the autograd Function (the kernel's
    training forward, the backward kernel) against autograd of the plain
    version (_compare_train: TOL, GRAD_TOL; the library column for the
    attention is autograd of torch's multi_head_attention_forward, for the
    MLP none), the backward kernel against its closed form and bit for
    bit over two runs; event ms, the profiler's device ms of the training
    forward (beside the lean forward's, the eval trunk's call), of the
    backward, which must launch its kernel, and of the plain recompute
    it replaced (autograd of the plain forward recomputed from the saved
    inputs), and the bound; per step weighted by its launches
    (swin_attention 2/2/6/2, the backward as often; swin_mlp's Function on
    block 0 only). Also the stochastic-depth blocks' unfused MLP branch
    (torch_mlp_branch, plain, no kernel): its forward and backward device
    ms at each stage, weighted by those blocks (1/2/6/2: 11 a step). Then
    the stochastic-depth masks: ops.dropout_masks over the 64 image rows
    for each block's probability, the kernel's bit for bit the plain
    version's, and the keep rate of 1M rows at 0.2 within 5 sd. Returns
    the bf16 results of stage 1 by kernel name (the backward kernels'
    under ``swin_attention_bwd`` and ``swin_mlp_bwd``), each with its step
    totals under ``step``."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels._util import \
        recompute_grads
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import \
        plain_dropout_masks
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_attention import (
        torch_window_attention, torch_window_attention_bwd)
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import (
        torch_mlp_branch, torch_swin_mlp, torch_swin_mlp_bwd)
    from medical_tri_modal_pilot_tpu_torch.models.swin import (
        STOCHASTIC_DEPTH, _shift_attn_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(19)
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results, step = {}, {}
    for si, (side, C, nW, shifted) in enumerate(SWIN_STAGES):
        nh, I, R = C // 32, BATCH * nW, BATCH * side * side
        smask = (torch.from_numpy(_shift_attn_mask(side, side, 7, 3)).to(dev)
                 if shifted else None)
        wts = (rnd(C, 3 * C, std=C ** -.5), rnd(3 * C, std=.1),
               rnd(C, C, std=C ** -.5), rnd(C, std=.1),
               rnd(nh, 49, 49, std=.5))
        mlp = (rnd(C, std=.1, mean=1.), rnd(C, std=.1),
               rnd(C, 4 * C, std=C ** -.5), rnd(4 * C, std=.1),
               rnd(4 * C, C, std=(4 * C) ** -.5), rnd(C, std=.1))
        n_attn = (SWIN_STAGE_LAUNCHES[si].get("mask", 0)
                  + SWIN_STAGE_LAUNCHES[si].get("none", 0))
        for dt in ((torch.float32, bf16) if si == 0 else (bf16,)):
            es = 2 if dt == bf16 else 4
            tag = "bf16" if dt == bf16 else "fp32"
            xw, x = rnd(I, 49, C).to(dt), rnd(R, C).to(dt)
            cot_a, cot_m = rnd(I, 49, C).to(dt), rnd(R, C).to(dt)
            cases = (
                ("swin_attention", f"[{I},49,{C}]",
                 lambda *a: ops.swin_attention(*a, smask, nh),
                 (xw,) + wts, cot_a, _swin_work(I, C, es), n_attn, n_attn,
                 (torch_window_attention, (smask, nh)),
                 lambda *a: torch_window_attention_bwd(*a[:-1], smask, nh,
                                                       a[-1]),
                 _mha_library_grad(xw, wts[:4], wts[4], smask, nh, cot_a),
                 ("window_attn_bwd_tc_kernel" if dt == bf16
                  else "window_attn_bwd_kernel", "col_sum_kernel")),
                ("swin_mlp", f"[{R},{C}]", ops.swin_mlp, (x,) + mlp, cot_m,
                 _mlp_work(R, C, es), SWIN_MLP_LAUNCHES[si],
                 1 if si == 0 else 0, (torch_swin_mlp, ()),
                 torch_swin_mlp_bwd, None,
                 ("layer_norm_kernel", "swin_ln_bwd_kernel",
                  "gemm_bf16_kernel" if dt == bf16 else "gemm_kernel",
                  "wgrad_tc_kernel" if dt == bf16 else "wgrad_kernel",
                  "col_sum_kernel")))
            for (name, shape, fwd, inputs, cot, work, n_fwd, n_bwd, plain,
                 closed, library, expect) in cases:
                fr, br = _compare_train(
                    f"{name}{shape} stage {si + 1} trainable", dt, fwd,
                    inputs, cot, None, *work, library)
                _bwd_repeats(fwd, inputs, cot)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in inputs]
                with torch.inference_mode():
                    lean, _ = _device_ms(lambda: fwd(*inputs))
                train, names = _device_ms(lambda: fwd(*leaves))
                out = fwd(*leaves)
                ops.reset_launches()
                got = torch.autograd.grad(out, leaves, cot,
                                          retain_graph=True)
                if (ops.launches[name + "_bwd"] != 1
                        or any(ops.recomputes.values())):
                    raise AssertionError(f"{name} stage {si + 1}: the "
                                         f"backward launched "
                                         f"{ops.launches}, recomputed "
                                         f"{ops.recomputes}")
                ref = closed(*inputs, cot)
                c_err = _grad_errors(got, ref)
                bwd, bnames = _device_ms(lambda: torch.autograd.grad(
                    out, leaves, cot, retain_graph=True))
                needs = (True,) * len(inputs)
                rec, _ = _device_ms(lambda: recompute_grads(
                    plain[0], inputs, needs, plain[1], cot))
                lib_dev = (None if library is None
                           else _device_ms(library[1])[0])
                kernels = sorted({n.split("<")[0].split("(")[0]
                                  for n in names if "mtp::" in n})
                missing = [k for k in expect
                           if not any(k in n for n in bnames)]
                print(f"device {name}{shape} stage {si + 1} {tag}: eval "
                      f"forward {lean:.4f} ms, training forward "
                      f"{train:.4f} ({' '.join(kernels)}), backward kernel "
                      f"{bwd:.4f}, plain recompute {rec:.4f}"
                      + ("" if lib_dev is None
                         else f", library backward {lib_dev:.4f}")
                      + f" (profiler; {len(bnames)} device kernels); "
                      f"against the closed form |err|_F/|closed|_F "
                      f"{' '.join(f'{e:.2e}' for e in c_err)}")
                if missing or not kernels:
                    raise AssertionError(f"{name} stage {si + 1}: the "
                                         f"training forward launched "
                                         f"{names}, the backward {bnames} "
                                         f"(missing {missing})")
                if not all(np.isfinite(e) and e <= GRAD_TOL[dt]
                           for e in c_err):
                    raise AssertionError(f"{name} stage {si + 1} {tag}: the "
                                         f"backward kernel disagrees with "
                                         f"its closed form")
                if dt != bf16:
                    continue
                fr.update(device_ms=train, eval_device_ms=lean)
                br.update(device_ms=bwd, recompute_device_ms=rec,
                          library_device_ms=lib_dev, closed_err_f=max(c_err),
                          form="backward kernel")
                for key, res, n in ((name, fr, n_fwd),
                                    (name + "_bwd", br, n_bwd)):
                    tot = step.setdefault(key, {"device_ms": 0.0,
                                                "bound_ms": 0.0,
                                                "launches": 0})
                    tot["device_ms"] += n * res["device_ms"]
                    tot["bound_ms"] += n * res["bound_ms"]
                    tot["launches"] += n
                    if key.endswith("_bwd"):
                        tot["recompute_device_ms"] = (
                            tot.get("recompute_device_ms", 0.0) + n * rec)
                if si == 0:
                    results[name] = dict(fr, shape=shape, form="training")
                    results[name + "_bwd"] = dict(br, shape=shape)
                del out, leaves, got, ref
            if dt == bf16:
                # the unfused MLP branch of the stochastic-depth blocks
                n_sd = SWIN_MLP_LAUNCHES[si] - (1 if si == 0 else 0)
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (x,) + mlp]
                bf, _ = _device_ms(lambda: torch_mlp_branch(*leaves))
                out = torch_mlp_branch(*leaves)
                bb, _ = _device_ms(lambda: torch.autograd.grad(
                    out, leaves, cot_m, retain_graph=True))
                print(f"device torch_mlp_branch[{R},{C}] stage {si + 1} "
                      f"bf16 (plain, {n_sd} blocks a step): forward "
                      f"{bf:.4f} ms, backward {bb:.4f} (profiler)")
                tot = step.setdefault("mlp_branch", {
                    "device_ms": 0.0, "bwd_device_ms": 0.0, "launches": 0})
                tot["device_ms"] += n_sd * bf
                tot["bwd_device_ms"] += n_sd * bb
                tot["launches"] += n_sd
                del out, leaves
        gc_collect()
    for key, tot in step.items():
        if key == "mlp_branch":
            print(f"swin trainable step totals, bf16, batch 64: "
                  f"torch_mlp_branch (plain) x{tot['launches']} forward "
                  f"{tot['device_ms']:.4f} ms, backward "
                  f"{tot['bwd_device_ms']:.4f} ms device")
            continue
        extra = ("" if "recompute_device_ms" not in tot else
                 f", the plain recompute {tot['recompute_device_ms']:.4f}")
        print(f"swin trainable step totals, bf16, batch 64: {key} "
              f"x{tot['launches']} {tot['device_ms']:.4f} ms device "
              f"(bound {tot['bound_ms']:.4f} ms{extra})")
        results[key]["step"] = tot
    # stochastic depth's masks: the kernel's bits are the plain version's
    seeds = [DROPOUT_SEED + k for k in range(12)]
    # the probabilities of Swin-T's blocks 1-11 (block 0 never drops)
    sd_probs = [STOCHASTIC_DEPTH * k / 11 for k in range(1, 12)]
    for p, seed in zip(sd_probs, seeds):
        got = ops.dropout_masks(BATCH, 0, 1, seed, p, dev)[1]
        want = plain_dropout_masks(BATCH, 0, 1, seed, p, dev)[1]
        if not torch.equal(got, want):
            raise AssertionError(f"stochastic depth p {p}: the kernel's "
                                 "mask differs from the plain version's")
    n = 1 << 20
    keep = ops.dropout_masks(n, 0, 1, DROPOUT_SEED, 0.2, dev)[1]
    rate = float(keep.float().mean())
    sd = (0.16 / n) ** .5
    print(f"stochastic depth: the masks of 11 probabilities over 64 rows "
          f"bit for bit the plain version's; keep rate over {n} rows at 0.2 "
          f"{rate:.5f} (0.8 +- {5 * sd:.5f})")
    if abs(rate - 0.8) > 5 * sd:
        raise AssertionError(f"stochastic depth keep rate {rate}")
    return results


def compare_ftv1_kernels() -> dict:
    """attn_block (lean, training, backward) and the ffn (dropout 0.1,
    training and backward) at feature_temporal_v1's instance shape
    [1536, 19, 256] with no key mask (every row live, 19 rows: one partial
    q tile a sample, no row tile skipped), fp32 and bf16, against the
    plain versions (TOL, GRAD_TOL; in bf16 also the profiler's device ms
    per form and the route's kernels, _train_forms), event and plain ms,
    the bound. Returns the bf16 results by kernel name."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import \
        attn_block_route
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import ffn_route
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(20)
    D, H, F, P, B, L = 256, 4, 1024, 0.1, FTV1_ROWS, FTV1_L

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    rows = B * L
    n = torch.full((B,), float(L), dtype=torch.float64)
    gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
    w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
    g1, be1 = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
    w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
    w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        es = 2 if dt == torch.bfloat16 else 4
        x = rnd(B, L, D).to(dt)
        # _attn_block_work counts BATCH samples: scale to B
        wf, wb = _attn_block_work(L, D, H, es, n[:BATCH])
        scale = B / BATCH
        wf, wb = ((wf[0] * scale, wf[1] * scale),
                  (wb[0] * scale, wb[1] * scale))
        wbytes = (2 * D * F + F + D) * 4
        cases = (
            (f"attn_block[{B},{L},256] ftv1 no mask",
             lambda *a: ops.attn_block(*a, None, (D // H) ** .5, H),
             (x, gamma, beta, w.to(dt), b.to(dt)), wf, wb,
             ATTN_BLOCK_ROUTE_KERNELS, attn_block_route(dt, D, H), True),
            (f"ffn[{rows},256] ftv1 dropout {P}",
             lambda *a: ops.ffn(*a, None, p=P, training=True,
                                seed=DROPOUT_SEED),
             (x, g1, be1, w1, b1, w2, b2),
             (2 * rows * D * es + wbytes, 4.0 * rows * D * F),
             (3 * rows * D * es + 2 * wbytes, 10.0 * rows * D * F),
             FFN_ROUTE_KERNELS, ffn_route(dt, D), False))
        res = []
        for tag, fwd, inputs, work_f, work_b, routes, route, lean in cases:
            cot = rnd(B, L, D).to(dt)
            if dt == torch.bfloat16:
                res.append(_train_forms(tag, dt, fwd, inputs, cot, None,
                                        work_f, work_b, routes, route,
                                        lean=lean))
                continue
            # fp32, the checking dtype: against the plain version only (its
            # FMA kernels' device ms are no main-path figure)
            if lean:
                with torch.inference_mode():
                    _compare(tag, dt, lambda: fwd(*inputs), work_f)
            _compare_train(tag, dt, fwd, inputs, cot, None, work_f, work_b)
        if dt == torch.bfloat16:
            (lr, fr, br), (_, fr2, br2) = res
            shape = f"[{B},{L},256]"
            results = {"attn_block": dict(fr, shape=shape, form="training",
                                          lean=lr),
                       "attn_block_bwd": dict(br, shape=shape),
                       "ffn": dict(fr2, shape=f"[{rows},256]",
                                   form="training"),
                       "ffn_bwd": dict(br2, shape=f"[{rows},256]")}
    return results


def _trunk_step_ms(power: str) -> None:
    """The Swin-T trunk alone at batch 64, bf16, seeded: the profiler's
    device ms of its eval forward (inference), its training forward
    (stochastic depth, the ops' Functions) and that forward's backward
    (the backward kernels and the rest of autograd), with the peak memory of a
    training forward and backward."""
    from medical_tri_modal_pilot_tpu_torch.models.modules import DropoutSeeds
    from medical_tri_modal_pilot_tpu_torch.models.registry import \
        init_parameters
    from medical_tri_modal_pilot_tpu_torch.models.swin import SwinTransformer
    dev = torch.device("cuda")
    trunk = SwinTransformer(in_channels=1, dtype=torch.bfloat16)
    init_parameters(trunk, torch.Generator().manual_seed(0))
    trunk = trunk.to(dev)
    img = torch.rand(BATCH, 1, 224, 224, generator=torch.Generator()
                     .manual_seed(1)).to(dev)
    cot = torch.randn(BATCH, 7, 7, 768, generator=torch.Generator()
                      .manual_seed(2)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        eval_ms, _ = _device_ms(lambda: trunk.eval()(img), reps=5)
    trunk.train()
    fwd_ms, _ = _device_ms(lambda: trunk(img, DropoutSeeds(0, 0)), reps=5)
    params = list(trunk.parameters())
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = trunk(img, DropoutSeeds(0, 0))
    bwd_ms, _ = _device_ms(lambda: torch.autograd.grad(
        out, params, cot, retain_graph=True), reps=5)
    peak = torch.cuda.max_memory_allocated()
    trunk.eval()
    print(f"swin-t trunk batch 64 bf16 ({power}): eval forward {eval_ms:.3f} "
          f"ms device, training forward {fwd_ms:.3f}, backward "
          f"{bwd_ms:.3f} (profiler); peak memory of a training forward "
          f"and backward {(peak - base) / 2 ** 30:.3f} GiB above the "
          f"weights")
    del out, trunk
    gc_collect()


def run_baselines(power: str) -> tuple:
    """Phase 19: the paper's baselines and the trainable trunk at full
    width, bf16 (BASELINES): first the trainable trunk's ops at each
    Swin-T stage and stochastic depth's masks (compare_swin_training),
    attn_block and the ffn at feature_temporal_v1's unmasked instance shape
    (compare_ftv1_kernels) and the trunk alone (_trunk_step_ms); then per
    name the eval against the plain path in bf16 and fp32 and one train
    step on both paths in fp32 and bf16 at dropout 0.1 (phase 7's gates,
    every trunk gradient by Frobenius ratio in float64), launch counts
    (no plain recompute); fusiontrainer Medfuse and tri_mbt_v2 also timed in
    turns, profiled (device busy, idle share) and their peak memory; a
    train step under --fusion-type uni_ehr; a
    fusiontrainer fold through the drivers and gru_d's, the CLI's default
    model (no --model), under --vslt-type carryforward. Returns (the
    kernels' results at this phase's shapes, each train path's
    launches)."""
    t_phase = time.perf_counter()
    results = compare_swin_training()
    results.update(compare_ftv1_kernels())
    _trunk_step_ms(power)
    counts = {}
    for name, argv in BASELINES.items():
        timed = name in BL_TIMED
        run_config(name, argv, power, timed=timed)
        counts[name] = run_train(name, argv, power, timed=timed, fit=False)
        gc_collect()
    counts["ft_uni"] = run_train("ft_uni", BL_UNI_EHR, power, timed=False)
    gc_collect()
    _driver_run("ft_medfuse", BASELINES["ft_medfuse"], BL_DRIVER_BATCHES,
                power)
    default = [a for a in BASELINES["gru_d"] if a not in ("--model",
                                                           "gru_d")]
    _driver_run("gru_d_default", default, BL_DRIVER_BATCHES, power)
    print("baselines train step (" + power + "): " + ", ".join(
        f"{BL_PATHS[n]} {TRAIN_STEP_MS[n]:.2f} ms/step" for n in BL_TIMED))
    print(f"baselines phase ({power}): {time.perf_counter() - t_phase:.1f} s")
    return results, counts


# the batch seeds of the stepgate mode; run_train's first batch is seed 10
STEPGATE_SEEDS = (10, 11, 12, 13, 14, 15)


def stepgate(root: str, power: str) -> None:
    """The bf16 step gate of _check_step_parity for tri_mbt_vmultivslt at
    dropout 0 (phase 16's tightest) on each of STEPGATE_SEEDS batches, from
    run_train's starting weights, for the package under ``root``: the
    kernel path's and the plain path's errors against the fp32 plain step,
    and the kernel path's largest over its bound (STEP_BF16_RATIO times
    the plain path's largest, plus 1e-2). Prints one line per batch and a
    JSON line; raises nothing on a gate's excess (it is a reading)."""
    sys.path.insert(0, os.path.abspath(root))
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    if not ops.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"stepgate: imported {ops.__file__}, not "
                             f"{root}")
    cfg = parse_config(MULTI_ARGV["vmultivslt"])
    state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    zero = ZERO_GRAD[:1]
    rows = []
    for seed in STEPGATE_SEEDS:
        batch = synthetic_batch(cfg, BATCH, seed=seed,
                                present_frac=TRAIN_BATCHES["vmultivslt"][0])
        runs = {(prec, plain): _train_run(
                    cfg.replace(precision=prec, dropout=0.0), state, batch,
                    plain)[1]
                for prec, plain in (("fp32", True), ("bf16", True),
                                    ("bf16", False))}
        k_err = _step_errors(runs["bf16", False], runs["fp32", True], zero)
        p_err = _step_errors(runs["bf16", True], runs["fp32", True], zero)
        bound = STEP_BF16_RATIO * max(p_err.values()) + 1e-2
        row = {"seed": seed, "kernel_max": max(k_err.values()),
               "plain_max": max(p_err.values()), "bound": bound,
               "share": max(k_err.values()) / bound,
               "kernel_median": statistics.median(k_err.values()),
               "plain_median": statistics.median(p_err.values())}
        rows.append(row)
        print(f"stepgate {root} ({power}) batch {seed}: kernel path "
              f"{_summary(k_err)}; plain path {_summary(p_err)}; largest "
              f"{row['share']:.4f} of the bound {bound:.4f}")
        del runs
        gc_collect()
    print("stepgate " + json.dumps({"root": root, "rows": rows}))


# the saver's forms in ``saver``: as it is (the state_dicts as views of the
# pinned buffers, one storage per dtype in the file), a clone per tensor
# (its first design), and the saver with the zip's CRC32 off
def _cloned_snapshot(view_result):
    def result(snapshot):
        clone = lambda t: t.clone() if torch.is_tensor(t) else t
        model, opt = view_result(snapshot)
        model = {k: clone(v) for k, v in model.items()}
        if opt is not None:
            opt = dict(opt, state={i: {k: clone(v) for k, v in st.items()}
                                   for i, st in opt["state"].items()})
        return model, opt
    return result


def saver_ab(power: str) -> None:
    """``python3 chip_smoke.py saver``: the async saver's cost to the train
    steps it overlaps. Config 4 at full width on phase 14's batches: the
    ms of a step with no save in flight, then per form of the writer
    (blocks of three saves in turns A B C C B A) the main thread's ms per
    save call and the ms of the six steps after each call."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    print(f"host: {os.cpu_count()} cpus, torch threads "
          f"{torch.get_num_threads()}")
    cfg = parse_config(DRIVER_ARGV)
    wire, _, table = _driver_loaders(cfg)
    tr = Trainer(cfg, get_model(cfg), torch.device("cuda"), eval_only=False,
                 iters_per_epoch=4, seed=0, txt_table=table)
    batches = wire["train"]

    def step() -> float:
        t0 = time.perf_counter()
        tr.train_step(batches[tr.step % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(4):
        step()
    idle = [step() for _ in range(12)]
    views = ckpt._Snapshot.result
    forms = {"views": (views, True),
             "clone per tensor": (_cloned_snapshot(views), True),
             "views, no crc32": (views, False)}
    path = os.path.join(DRIVER_DIR, "saver_ab.pth")
    os.makedirs(DRIVER_DIR, exist_ok=True)
    got = {name: {"call": [], "steps": []} for name in forms}
    try:
        for name in list(forms) + list(forms)[::-1]:
            result, crc = forms[name]
            ckpt._Snapshot.result = result
            torch.serialization.set_crc32_options(crc)
            saver = ckpt.AsyncCheckpointer()
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                saver.save(path, tr, 0.0, 1)
                got[name]["call"].append((time.perf_counter() - t0) * 1e3)
                got[name]["steps"] += [step() for _ in range(6)]
                saver.wait()
                step()
                step()
    finally:
        ckpt._Snapshot.result = views
        torch.serialization.set_crc32_options(True)
    print(f"saver ab ({power}): no save in flight "
          f"{statistics.median(idle):.2f} ms/step median of {len(idle)} "
          f"{[round(x, 1) for x in idle]}")
    for name, g in got.items():
        print(f"saver ab ({power}): {name}: call median "
              f"{statistics.median(g['call']):.2f} ms "
              f"{[round(x, 1) for x in g['call']]}; the 6 steps after each "
              f"call median {statistics.median(g['steps']):.2f} ms "
              f"{[round(x, 1) for x in g['steps']]}")


# ---------------------------------------------------------------------------
# the other model widths (phases 3w and 17): d_model 128 with 4 heads
# (d_head 32), 512 with 4 heads (d_head 128; the ffn's split route) and 256
# with 2 heads (d_head 128), as "C/H"
WIDTH_CASES = ((128, 4), (512, 4), (256, 2))
# the kernels each attn_block route launches (forward, backward; the
# backward recomputes q|k|v with the forward's projection kernel)
ATTN_BLOCK_ROUTE_KERNELS = {
    "tc": (("block_qkv_tc_kernel", "block_attn_tc_kernel"),
           ("block_delta_kernel", "block_dkv_tc_kernel",
            "block_dq_tc_kernel", "block_ln_bwd_tc_kernel")),
    "fma": (("proj_kernel", "attn_kernel"),
            ("dkv_kernel", "dq_kernel", "ln_bwd_kernel"))}
# the kernels each ffn route launches (kernels/ffn.py::ffn_route)
FFN_ROUTE_KERNELS = {
    "tc": (("ffn_fwd_tc_kernel",), ("ffn_bwd_tc_kernel",)),
    "fma": (("ffn_kernel",), ("ffn_bwd_kernel",)),
    "wgmma_split": (("ffn_ln_kernel", "wg_gemm_kernel"),
                    ("ffn_dz_kernel", "ffn_ln_bwd_rows_kernel")),
    "fma_split": (("ffn_ln_kernel", "gemm_kernel"),
                  ("ffn_dz_kernel", "ffn_ln_bwd_kernel"))}


# the redesigned forms' earlier readings (events ms, profiler device ms)
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): the ffn split route at
# C 512 before the wgmma mainloop (R = 64 x 1024, p 0.1, the TIE stream's
# tile flags), the 3-D block-mask attn_block at the vslt shape
# [64, 1016, 256] before the tile map
EARLIER_MS = {"ffn_split": (1.771, 1.4121), "ffn_split_bwd": (4.242, 3.4541),
              "attn_block_3d": (1.043, 0.899),
              "attn_block_3d_bwd": (2.954, 2.683)}


def _print_earlier(what, res, earlier) -> None:
    """A redesigned form's events and device ms beside its bound and its
    earlier reading."""
    print(f"{what}: events {res['ms']:.3f} ms, device "
          f"{res.get('device_ms') or float('nan'):.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}); earlier "
          f"{earlier[0]:.3f} / {earlier[1]:.4f} (events / device)",
          flush=True)


def _width_key(C: int, H: int = 0) -> str:
    return f"C{C}" + (f"/H{H}" if H else "")


def _add_width(results, name, key, res, shape) -> None:
    """results[name][key] = res with its shape (the kernels line's
    ``widths`` entry of the kernel)."""
    results.setdefault(name, {})[key] = dict(res, shape=shape)


def _train_forms(tag, dt, fwd, inputs, cot, live, work_f, work_b, routes,
                 route, lean=True, library=None):
    """The lean form (``lean``), the training form and the backward against
    the plain path (_compare, _compare_train), and the profiler's device
    ms per call of each (_device_forms, which holds the launched kernels
    to the route's); ``library``: (forward, backward) calls of PyTorch's
    own that compute the same, timed beside them. (lean, forward,
    backward) results, lean None when not asked."""
    r = None
    if lean:
        with torch.inference_mode():
            r = _compare(tag, dt, lambda: fwd(*inputs), work_f, live,
                         library=library and library[0])
    fr, br = _compare_train(tag, dt, fwd, inputs, cot, live, work_f, work_b,
                            library)
    dres = _device_forms(tag, dt, fwd, inputs, cot, library, routes, route)
    for res, form, i in ((r, "lean", 0), (fr, "train", 0), (br, "bwd", 1)):
        if res is not None:
            res["device_ms"] = dres[form]
            res["library_device_ms"] = dres["library"][i]
    return r, fr, br


def _sdpa_library(q, k, v, mask, cot):
    """scaled_dot_product_attention on [B, H, L, Dh] copies of q, k, v
    made before the timing (True = attend), and its backward: the library
    column of the masked attention."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    keep = None if mask is None else ~mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
    out_t, cot_t = sdpa(), cot.transpose(1, 2).contiguous()
    return sdpa, lambda: torch.autograd.grad(out_t, (qt, kt, vt), cot_t,
                                             retain_graph=True)


def compare_width_kernels() -> dict:
    """Phase 3w: each kernel at the other model widths against its plain
    version, fp32 and bf16, at the shapes config 4 gives it there (batch
    64): umse at D 512; attn_block at [64, 1024, C] under the TIE key mask
    (lean, training, backward) and under a multitoken txt stream's 3-D
    block mask at [64, 142, C]; ffn at C 128 and 512 (the split route)
    with dropout 0.1 over the vslt stream's rows, its masks at 512 held
    to dropout_masks' bit for bit; rowmm (the LN form at one rank's q|k|v
    under --mp-size 2, W [C, 3C/2], and the plain form, W [C, C]) at Cin
    128 and 512; the masked attention at d_head 128 (the TP self shape of
    the TIE stream, the cross shapes, a block mask, no mask). Each with
    its error, event ms, the profiler's device ms, plain ms and bound.
    Returns {kernel: {width: bf16 result}} for the kernels line."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
        attention_route
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
        attn_block_route, key_ends)
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
        ffn_bwd_tiles, ffn_route)
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import (
        BLOCK_R, rowmm_route)
    from medical_tri_modal_pilot_tpu_torch.kernels.umse import (
        cuda_umse_bwd, torch_umse_bwd)
    from medical_tri_modal_pilot_tpu_torch.models.mbt import block_key_mask
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(17)
    bf16 = torch.bfloat16
    results = {}

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    # umse at D 512: the forward against torch_umse, the backward kernel
    # against its closed form (fp32 by Frobenius ratio within 1e-2, bf16
    # within STEP_BF16_RATIO of the bf16 closed form's distance from the
    # fp32 one, as phase 5b)
    D = 512
    x, params = _umse_case(g, dev)
    params = [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
              rnd(D, std=.1)] * 2 + [rnd(20, D)]
    R = BATCH * TIE_LEN
    for dt in (torch.float32, bf16):
        es = 2 if dt == bf16 else 4
        with torch.inference_mode():
            r = _compare(f"umse[64,1000,{D}]", dt,
                         lambda: ops.umse(x, *params, dt),
                         (R * 12 + R * D * es + 28 * D * 4,
                          30.0 * R * D), rate=torch.float32)
        r["device_ms"] = _device_ms(lambda: ops.umse(x, *params, dt),
                                    expect=("umse_fwd_kernel",))[0]
        dout = rnd(BATCH, TIE_LEN, D).to(dt)
        got = cuda_umse_bwd(x, *params, dout, dt)
        ref32 = torch_umse_bwd(x, *params, dout.float(), torch.float32)
        plain = torch_umse_bwd(x, *params, dout, dt)
        k_err, p_err = _grad_errors(got, ref32), _grad_errors(plain, ref32)
        kernel = lambda: cuda_umse_bwd(x, *params, dout, dt)
        b = {"max_abs_err": max(float((a - e).abs().max())
                                for a, e in zip(got, plain)),
             "grad_err_f": max(k_err), "ms": _median_ms(kernel),
             "device_ms": _device_ms(kernel,
                                     expect=("umse_bwd_kernel",))[0],
             "plain_ms": _median_ms(lambda: torch_umse_bwd(
                 x, *params, dout, dt)),
             **_bound(R * D * es + R * 12 + 56 * D * 4, 42.0 * R * D,
                      torch.float32), "library_ms": None}
        tag = "bf16" if dt == bf16 else "fp32"
        print(f"kernel umse_bwd [64,1000,{D}] {tag}: |err|_F/|fp32|_F "
              f"{max(k_err):.2e} (the {tag} closed form's {max(p_err):.2e})"
              f" ms={b['ms']:.3f} device_ms={b['device_ms']:.4f} "
              f"plain_ms={b['plain_ms']:.3f} bound_ms={b['bound_ms']:.4f} "
              f"({b['bound_by']}); forward device_ms={r['device_ms']:.4f}")
        ok = (all(np.isfinite(e) and e <= 1e-2 for e in k_err)
              if dt == torch.float32 else
              all(np.isfinite(k) and k <= STEP_BF16_RATIO * p + 1e-2
                  for k, p in zip(k_err, p_err)))
        if not ok:
            raise AssertionError(f"umse_bwd D {D} {tag} disagrees")
        if dt == bf16:
            _add_width(results, "umse", _width_key(D), r, "[64,1000,3]")
            _add_width(results, "umse_bwd", _width_key(D), b,
                       f"[64,1000,{D}]")
        del got, ref32, plain, dout
    del x, params

    # the TIE stream's key mask and a multitoken txt stream's block mask
    L = 1024
    lengths = torch.randint(5, TIE_LEN + 1, (BATCH,), generator=g) + 5
    lengths[3] = 0
    tie_mask = length_key_mask(lengths.to(dev), L)
    tie_live = torch.arange(L, device=dev)[None] < key_ends(
        tie_mask)[:, None].long()
    Lb = 142
    vlen = torch.randint(3, 131, (BATCH,), generator=g)
    vlen[1] = 2   # a note-less sample: rows with every key masked
    block_mask = block_key_mask(vlen.to(dev), Lb - 12, 4, 2, False)
    for C, H in WIDTH_CASES:
        wk = _width_key(C, H)
        n = key_ends(tie_mask).double()
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            gamma, beta = rnd(C, std=.1, mean=1.), rnd(C, std=.1)
            w = rnd(C, 3 * C, std=C ** -.5).to(dt)
            b = rnd(3 * C, std=.1).to(dt)
            for form, mask, Lx, live in (
                    ("key", tie_mask, L, tie_live),
                    ("3d", block_mask, Lb, None)):
                xa = rnd(BATCH, Lx, C).to(dt)
                cot = rnd(BATCH, Lx, C).to(dt)
                nn = n if form == "key" else torch.full((BATCH,), float(Lx),
                                                        dtype=torch.float64)
                if live is not None:
                    cot = cot * live[:, :, None]
                sb = BATCH * Lx * C * es
                wb = (3 * C * C + 3 * C) * es
                work_f = (3 * sb + 8 * BATCH * H * Lx + wb,
                          float((6 * nn * C * C + 4 * nn * nn * C).sum()))
                work_b = (4 * sb + 8 * BATCH * H * Lx + wb + 12 * C * C,
                          float((10 * nn * nn * C + 18 * nn * C * C).sum()))
                tag = f"attn_block{'_3d' if form == '3d' else ''}" \
                      f"[64,{Lx},{C}] heads {H}"
                r, fr, br = _train_forms(
                    tag, dt,
                    lambda *a, m=mask: ops.attn_block(*a, m, (C // H) ** .5,
                                                      H),
                    (xa, gamma, beta, w, b), cot, live, work_f, work_b,
                    ATTN_BLOCK_ROUTE_KERNELS, attn_block_route(dt, C, H))
                if dt == bf16:
                    name = "attn_block" + ("_3d" if form == "3d" else "")
                    shape = f"[64,{Lx},{C}]"
                    _add_width(results, name, wk, dict(r, train=fr), shape)
                    _add_width(results, name + "_bwd", wk, br, shape)
                del xa, cot
        if C == 256:
            continue
        # the ffn at C 128 (fused) and 512 (split), dropout 0.1, over the
        # TIE stream's rows and tile flags
        F, P = 4 * C, 0.1
        g1, be1 = rnd(C, std=.1, mean=1.), rnd(C, std=.1)
        w1, b1 = rnd(C, F, std=C ** -.5), rnd(F, std=.1)
        w2, b2 = rnd(F, C, std=F ** -.5), rnd(C, std=.1)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xf = rnd(BATCH, L, C).to(dt)
            flags = ffn_row_blocks(xf, tie_mask)
            rows = flags.repeat_interleave(L // flags.shape[1], dim=1)
            n_live = float(rows.sum())
            cot = rnd(BATCH, L, C).to(dt) * rows[:, :, None]
            wbytes = (2 * C * F + F + C) * 4
            work_f = (2 * BATCH * L * C * es + wbytes, 4.0 * n_live * C * F)
            work_b = (3 * BATCH * L * C * es + 2 * wbytes,
                      10.0 * n_live * C * F)
            fwd = lambda *a: ops.ffn(*a, flags, p=P, training=True,
                                     seed=DROPOUT_SEED)
            _, fr, br = _train_forms(
                f"ffn[{BATCH * L},{C}] dropout {P}", dt, fwd,
                (xf, g1, be1, w1, b1, w2, b2), cot, rows, work_f, work_b,
                FFN_ROUTE_KERNELS, ffn_route(dt, C), lean=False)
            if C == 512:
                # the masks: where dropout_masks drops an output element the
                # forward leaves x, bit for bit; where it drops a hidden
                # one the backward's dropped hidden is 0, and it is 0
                # nowhere else but at a ReLU
                k1, k2 = ops.dropout_masks(BATCH * L, F, C, DROPOUT_SEED, P,
                                           dev)
                with torch.inference_mode():
                    y = fwd(xf, g1, be1, w1, b1, w2, b2)
                hd = ffn_bwd_tiles(xf, g1, be1, w1, b1, w2, flags, P,
                                   DROPOUT_SEED, cot)[3]
                live2 = rows.reshape(-1)
                y2, x2 = y.reshape(-1, C)[live2], xf.reshape(-1, C)[live2]
                out_drop = ~k2[live2]
                hid_drop = ~k1[live2]
                hd2 = hd[live2]
                ok = (bool(torch.equal(y2[out_drop], x2[out_drop]))
                      and bool((hd2[hid_drop] == 0).all())
                      and bool(k1[live2][hd2 != 0].all()))
                kept = float(k1.float().mean()), float(k2.float().mean())
                print(f"ffn split C {C} {'bf16' if dt == bf16 else 'fp32'}:"
                      f" masks against dropout_masks on the live rows: "
                      f"{int(out_drop.sum())} dropped outputs are x bit for "
                      f"bit, {int(hid_drop.sum())} dropped hidden units 0, "
                      f"every nonzero hidden unit kept: {ok} (keep rates "
                      f"{kept[0]:.4f}, {kept[1]:.4f})")
                if not ok or int(out_drop.sum()) == 0:
                    raise AssertionError("ffn split route: masks differ "
                                         "from dropout_masks'")
                del y, hd, k1, k2
                if dt == bf16:
                    _bwd_repeats(fwd, (xf, g1, be1, w1, b1, w2, b2), cot)
                    _print_earlier("ffn split C 512 (wgmma) training "
                                   "forward", fr, EARLIER_MS["ffn_split"])
                    _print_earlier("ffn split C 512 (wgmma) backward", br,
                                   EARLIER_MS["ffn_split_bwd"])
                    _split_kernels(fwd, (xf, g1, be1, w1, b1, w2, b2), cot,
                                   flags)
            if dt == bf16:
                shape = f"[{BATCH * L},{C}]"
                if C == 512:
                    # the split route on the wgmma mainloop
                    src = ("medical_tri_modal_pilot_tpu_torch/csrc/"
                           "ffn_split.cu + csrc/wgmma.cuh")
                    fr, br = dict(fr, source=src), dict(br, source=src)
                _add_width(results, "ffn", wk, fr, shape)
                _add_width(results, "ffn_bwd", wk, br, shape)
            del xf, cot
        # rowmm at Cin = C: the LN form at one rank's q|k|v (--mp-size 2)
        # and the plain form, over 256-row block flags of the TIE lengths
        bflags = ffn_row_blocks(tie_mask[:, :, None], tie_mask, BLOCK_R)
        blive = bflags.repeat_interleave(BLOCK_R, dim=1)
        n_live = float(blive.sum())
        for cout, ln in ((3 * C // 2, True), (C, False)):
            name = "rowmm_ln" if ln else "rowmm"
            for dt in (torch.float32, bf16):
                es = 2 if dt == bf16 else 4
                xr = rnd(BATCH, L, C).to(dt)
                w, b = rnd(C, cout, std=C ** -.5).to(dt), \
                    rnd(cout, std=.1).to(dt)
                cot = rnd(BATCH, L, cout).to(dt) * blive[:, :, None]
                if ln:
                    inputs = (xr, rnd(C, std=.1, mean=1.), rnd(C, std=.1),
                              w, b)
                    cot = tuple(c.contiguous() for c in
                                cot.split(cout // 3, -1))
                    fwd = lambda *a: ops.rowskip_ln_affine(*a, bflags)
                else:
                    inputs = (xr, w, b)
                    fwd = lambda *a: ops.rowskip_affine(*a, bflags)
                wbytes = (C * cout + cout) * es + (8 * C if ln else 0)
                R = BATCH * L
                library = None
                if not ln:
                    # torch.addmm and its autograd.grad: the plain form's
                    # library column
                    xl, wl, bl = (t.detach().clone().requires_grad_()
                                  for t in (xr.reshape(R, C), w, b))
                    out_t = torch.addmm(bl, xl, wl)
                    cot_t = cot.reshape(R, cout)
                    library = (lambda: torch.addmm(b, xr.reshape(R, C), w),
                               lambda: torch.autograd.grad(
                                   out_t, (xl, wl, bl), cot_t,
                                   retain_graph=True))
                work_f = ((n_live * C + R * cout) * es + wbytes,
                          2.0 * n_live * C * cout)
                work_b = ((n_live * (C + cout) + R * C) * es + wbytes
                          + (C * cout + cout) * 4, 4.0 * n_live * C * cout)
                _, fr, br = _train_forms(
                    f"{name}[{R},{C}]x[{C},{cout}]", dt, fwd, inputs, cot,
                    blive, work_f, work_b, ROWMM_ROUTE_KERNELS,
                    rowmm_route(dt, C), lean=False, library=library)
                del library
                if dt == bf16:
                    shape = f"[{R},{C}]x[{C},{cout}]"
                    _add_width(results, name, _width_key(C), fr, shape)
                    _add_width(results, name + "_bwd", _width_key(C), br,
                               shape)
                del xr, cot, inputs

    # the masked attention at d_head 128: the TIE stream's TP self shape
    # (256 / 2 heads: one head a rank; 512 / 4: two), the cross shapes of
    # a 512-wide cross transformer, a block mask and no mask
    D = 128
    cases = [("tp_self", BATCH, 2, L, L, "tie")]
    cases += [(name, BATCH, 4, Lq, Lk, kind)
              for name, Lq, Lk, kind in CROSS_SHAPES]
    cases += [("block", 2, 2, 130, 70, "block"), ("none", 3, 2, 54, 54,
                                                   "none")]
    for name, B, H, Lq, Lk, kind in cases:
        q, k, v, mask, is_self, live = _attention_case(g, dev, B, H, Lq, Lk,
                                                       D, kind)
        for dt in (torch.float32, bf16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            cot = torch.randn(B, Lq, H, D, generator=g).to(dev).to(dt)
            cot = cot * live[:, :, None, None]
            tag = f"attention {name} q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
            library = (_sdpa_library(qd, kd, vd, mask, cot)
                       if name in ("tp_self", "cross_v", "cross_o") else None)
            r, fr, br = _train_forms(
                tag, dt, lambda *a: ops.attention(*a, mask, D ** .5, is_self),
                (qd, kd, vd), cot, live,
                _attention_work(qd, kd, mask, is_self),
                _attention_work(qd, kd, mask, is_self, backward=True),
                ATTN_ROUTE_KERNELS, attention_route(dt, D), library=library)
            del library
            if dt == bf16 and name in ("tp_self", "cross_v"):
                key = f"dh{D}" + ("/tp" if name == "tp_self" else "")
                shape = f"q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
                _add_width(results, "attention", key, dict(r, train=fr),
                           shape)
                _add_width(results, "attention_bwd", key, br, shape)
    print(f"width kernels phase: {time.perf_counter() - t_phase:.1f} s")
    return results


# phase 17: config 4 at the other widths (the rest as the flagship's:
# bf16, batch 64, TIE-len 1000, 6 layers, --dropout 0.1, adamw), its
# packed and overflowing batches
WIDTH_BATCHES = [0.5, 0.75]


def _split_kernels(fwd, inputs, cot, flags) -> None:
    """The ffn split route kernel by kernel: the profiler's device ms of
    each kernel one training forward (dropout 0.1, and 0) and one backward
    launch, so that the Philox draws of fc1's epilogue show as the
    difference of its two forward readings."""
    from medical_tri_modal_pilot_tpu_torch import ops
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    y = fwd(*leaves)
    calls = (("forward p 0.1", lambda _: fwd(*inputs)),
             ("forward p 0", lambda _: ops.ffn(*inputs, flags, p=0.0,
                                               training=True,
                                               seed=DROPOUT_SEED)),
             ("backward", lambda _: torch.autograd.grad(
                 y, leaves, cot, retain_graph=True)))
    for what, call in calls:
        items, busy, _ = _step_split(call, None)
        names = [key.split("(")[0].replace("void ", "").replace("mtp::", "")
                 for _, _, key in items]
        print(f"ffn split C 512 (wgmma) {what}: {busy:.4f} device ms; "
              + ", ".join(f"{k[:64]} x{n} {t / 1e3:.4f}"
                          for k, (t, n, _) in zip(names, items)))
    del y, leaves


def run_widths(power: str) -> dict:
    """Phase 17: tri_mbt_vsltcls on config 4's flags at each of
    WIDTH_CASES. Eval: the launch counts of config 4 (every attn_block,
    ffn and umse call on its kernel: a call on the plain path would miss
    its count), the probabilities against the plain path in bf16 and, on
    the same weights, in fp32 (phase 4's bounds), ms/step in turns. Train:
    the launch counts, peak device memory, ms/step in turns (at C 512 a
    profiled step: device time by kernel, the idle share), and one step
    from the same weights on both paths in fp32 and bf16 at dropout 0.1
    (phase 7's gates). Returns the train launch counts per width."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counts = {}
    for C, H in WIDTH_CASES:
        name = f"config4 d{C} h{H}"
        argv = CONFIG4 + ["--transformer-dim", str(C),
                          "--transformer-num-head", str(H)]
        cfg = parse_config(argv)
        widths = (cfg.transformer_dim, cfg.transformer_num_head,
                  cfg.transformer_num_layers, cfg.tie_len, cfg.precision,
                  cfg.dropout, cfg.optim)
        if widths != (C, H, 6, TIE_LEN, "bf16", 0.1, "adamw"):
            raise AssertionError(f"{name}: {widths}")
        batches = [synthetic_batch(cfg, BATCH, seed=40 + s, present_frac=f)
                   for s, f in enumerate(WIDTH_BATCHES)]
        n = len(batches)
        model = get_model(cfg, torch.Generator().manual_seed(0))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        ev = Trainer(cfg, model, dev, eval_only=True)
        ops.reset_launches()
        probs, _, rows = _eval_steps(ev, batches)
        torch.cuda.synchronize()
        got = dict(ops.launches)
        print(f"{name}: launches over {n} eval steps: {got}; trunk rows "
              f"{rows}")
        _check_counts(f"{name} eval", got, LAUNCHES_PER_STEP["config4"], n)
        with ops.reference_path():
            ref, _, _ = _eval_steps(ev, batches)
        d16 = float(np.max(np.abs(probs - ref)))
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_ms(ev, batches, reference))
        del ev
        c32 = cfg.replace(precision="fp32")
        ev32 = Trainer(c32, get_model(c32, torch.Generator().manual_seed(0)),
                       dev, eval_only=True)
        p32, _, _ = _eval_steps(ev32, batches)
        with ops.reference_path():
            r32, _, _ = _eval_steps(ev32, batches)
        d32 = float(np.max(np.abs(p32 - r32)))
        del ev32
        print(f"{name} eval ({power}): max |prob - plain prob| bf16 "
              f"{d16:.3e} (tol {PROB_TOL['bf16']}), fp32 {d32:.3e} (tol "
              f"{PROB_TOL['fp32']}); kernels {np.mean(ms[False]):.2f} "
              f"ms/step, plain {np.mean(ms[True]):.2f} ms/step; rounds "
              f"{ms[False]} / {ms[True]}")
        if not np.all(np.isfinite(probs)) or d16 > PROB_TOL["bf16"] \
                or d32 > PROB_TOL["fp32"]:
            raise AssertionError(f"{name}: eval disagrees with the plain "
                                 "path")

        # train: the launches of two steps, peak memory, ms/step in turns
        model.load_state_dict(state)
        tr = Trainer(cfg, model, dev, eval_only=False, seed=0)
        torch.cuda.synchronize()
        gc_collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses = [tr.train_step(bt) for bt in batches]
        torch.cuda.synchronize()
        got = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
        print(f"{name}: launches over {n} train steps: {got}; losses "
              f"{losses}; peak device memory {peak / 2 ** 30:.3f} GiB "
              f"(before the steps {base / 2 ** 30:.3f} GiB)")
        _check_counts(f"{name} train", got,
                      TRAIN_LAUNCHES_PER_STEP["config4"], n)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: train loss {losses}")
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_train_ms(tr, batches, reference))
        print(f"{name} train step ({power}): kernels "
              f"{np.mean(ms[False]):.2f} ms/step, plain "
              f"{np.mean(ms[True]):.2f} ms/step; rounds {ms[False]} / "
              f"{ms[True]}")
        if C == 512:
            # where the step's device time goes at the ffn's split width
            _profile_step(name, tr, batches[0], power, train=True)
        counts[name] = got
        del tr, model
        gc_collect()
        _check_step_parity(name, cfg, state, batches[0],
                           [("fp32", 0.1), ("bf16", 0.1)])
        del state
        gc_collect()
    print(f"widths phase ({power}): {time.perf_counter() - t_phase:.1f} s")
    return counts


# ``gradprobe``: phase 17's widths and the flagship's, each fp32 step
# read three ways: the kernel path and the plain path against the plain
# path with every weight moved by one fp32 rounding (2^-23 relative), so a
# gradient error of the kernels' that the plain path shows as much against
# itself comes from the function's sensitivity, not from a kernel
GRADPROBE_CASES = ((256, 2), (256, 4), (512, 4), (128, 4))


def _error_spike(a, b, n, top: int = 3) -> float:
    """The share of |a - b|_F^2 on tensor ``n`` that its ``top`` largest
    elements carry."""
    d = (a[n][0] - b[n][0]).double().flatten() ** 2
    return float(d.topk(min(top, d.numel())).values.sum() / d.sum()) \
        if float(d.sum()) > 0 else 0.0


def gradprobe(power: str) -> None:
    """The fp32 train step's gradient errors at GRADPROBE_CASES on phase
    17's first batch, at dropout 0 and 0.1: kernel against plain, and the
    nudged plain against plain; for the kernel path's worst tensor, the
    share of its squared error in its three largest elements (a ReLU that
    one path's rounding flips moves a whole element)."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    for C, H in GRADPROBE_CASES:
        cfg = parse_config(CONFIG4 + ["--transformer-dim", str(C),
                                      "--transformer-num-head", str(H)])
        batch = synthetic_batch(cfg, BATCH, seed=40,
                                present_frac=WIDTH_BATCHES[0])
        state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
        g = torch.Generator().manual_seed(1)
        nudged = {k: v * (1 + 2.0 ** -23 * (2 * torch.randint(
            0, 2, v.shape, generator=g) - 1)) if v.is_floating_point()
            else v for k, v in state.items()}
        for p in (0.0, 0.1):
            c = cfg.replace(precision="fp32", dropout=p)
            _, kern, _ = _train_run(c, state, batch, False)
            _, plain, _ = _train_run(c, state, batch, True)
            _, moved, _ = _train_run(c, nudged, batch, True)
            e_k, e_m = _step_errors(kern, plain), _step_errors(moved, plain)
            worst = max(e_k, key=e_k.get)
            print(f"gradprobe d{C} h{H} fp32 dropout {p} ({power}): kernel "
                  f"vs plain {_summary(e_k)}; nudged plain vs plain "
                  f"{_summary(e_m)}; {worst}: kernel {e_k[worst]:.3e} "
                  f"(top-3 share {_error_spike(kern, plain, worst):.3f}), "
                  f"nudged {e_m[worst]:.3e} (top-3 share "
                  f"{_error_spike(moved, plain, worst):.3f})", flush=True)
            del kern, plain, moved
            gc_collect()


# ``keyprobe``: the fp32 step at C 512 / 4 heads (d_head 128), dropout 0,
# on phase 17's first batch, with one kernel at a time swapped for its
# plain version; then the attention block and the FFN alone at that width
# against a float64 evaluation of the same function, kernel and plain
# path each, so that a kernel whose rounding is worse than the plain
# path's shows apart from the function's own sensitivity
KEYPROBE_SWAPS = ("attn_block", "ffn", "umse")


def _f64_stdln(x, gamma, beta):
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    var = ((xd - mu) ** 2).sum(-1, keepdim=True) / (xd.shape[-1] - 1)
    return (xd - mu) / (var.clamp_min(1e-24).sqrt() + 1e-6) \
        * gamma.double() + beta.double()


def _f64_attn_block(x, gamma, beta, w, b, mask, H):
    """x + MHA(StdLN(x)) in float64 (the plain version's math, no
    roundings): the yardstick of the fp32 paths' rounding."""
    ln = _f64_stdln(x, gamma, beta)
    B, L, C = x.shape
    q, k, v = (ln @ w.double() + b.double()).split(C, dim=-1)
    q, k, v = (t.reshape(B, L, H, C // H) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(C // H)
    s = s.masked_fill(mask[:, None, None, :], -65504.0)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return x.double() + o.reshape(B, L, C)


def _f64_ffn(x, gamma, beta, w1, b1, w2, b2):
    h = torch.relu(_f64_stdln(x, gamma, beta) @ w1.double() + b1.double())
    return x.double() + h @ w2.double() + b2.double()


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def keyprobe(power: str) -> None:
    """The fp32 ``key_proj`` reading at C 512 / 4 heads, dropout 0: the
    step kernel against plain with each of KEYPROBE_SWAPS on its plain
    version; then one attention block and one FFN at [64, 1024, 512]
    (seeded inputs, the TIE key mask) against float64, each gradient of
    the kernel and of the plain path by Frobenius ratio."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    C, H = 512, 4
    cfg = parse_config(CONFIG4 + ["--transformer-dim", str(C),
                                  "--transformer-num-head", str(H)])
    batch = synthetic_batch(cfg, BATCH, seed=40,
                            present_frac=WIDTH_BATCHES[0])
    state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    c = cfg.replace(precision="fp32", dropout=0.0)
    _, plain, _ = _train_run(c, state, batch, True)
    _, kern, _ = _train_run(c, state, batch, False)
    e_k = _step_errors(kern, plain)
    keys = sorted((n for n in e_k if "key_proj.linear.weight" in n),
                  key=e_k.get, reverse=True)
    print(f"keyprobe d{C} h{H} fp32 dropout 0 ({power}): kernel vs plain "
          f"{_summary(e_k)}; key_proj weights "
          + ", ".join(f"{n} {e_k[n]:.3e}" for n in keys[:3]), flush=True)
    # the worst one's error as a matrix: the share of its squared norm in
    # the first singular value (1 for a change to one row's cotangent,
    # an outer product), its top-3 element share, and the tensor's norm
    # beside its layer's query_proj weight gradient's
    worst = keys[0]
    diff = (kern[worst][0] - plain[worst][0]).double()
    sv = torch.linalg.svdvals(diff)
    q = worst.replace("key_proj", "query_proj")
    print(f"keyprobe {worst}: first singular value carries "
          f"{float(sv[0] ** 2 / (sv ** 2).sum()):.4f} of the error's "
          f"squared norm, top-3 elements {_error_spike(kern, plain, worst):.4f}"
          f"; |grad| {float(plain[worst][0].norm()):.3e} against "
          f"query_proj's {float(plain[q][0].norm()):.3e}", flush=True)
    for swap in KEYPROBE_SWAPS:
        _, part, _ = _train_run(c, state, batch, (swap,))
        e_s = _step_errors(part, plain)
        print(f"keyprobe {swap} on its plain version: vs plain "
              f"{_summary(e_s)}; " + ", ".join(
                  f"{n} {e_s[n]:.3e}" for n in keys[:3]), flush=True)
        del part
        gc_collect()
    del kern, plain
    gc_collect()
    g = np.random.default_rng(7)
    dev = torch.device("cuda")

    def t(*shape, scale=1.0):
        return torch.from_numpy(g.standard_normal(shape).astype(
            np.float32) * scale).to(dev)
    lens = torch.from_numpy(g.integers(5, TIE_LEN + 1, BATCH)).to(dev) + 5
    mask = torch.arange(TIE_LEN + 24, device=dev)[None, :] >= lens[:, None]
    L = TIE_LEN + 24
    x = t(BATCH, L, C)
    gam, bet = 1.0 + 0.1 * t(C), 0.1 * t(C)
    w, b = t(C, 3 * C, scale=C ** -0.5), 0.1 * t(3 * C)
    dy = t(BATCH, L, C) * (~mask)[..., None]
    leaves = [x, gam, bet, w, b]
    xs = [a.double().requires_grad_() for a in leaves]
    out = _f64_attn_block(*xs, mask, H)
    ref = torch.autograd.grad(out, xs, dy.double())
    for label, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", ops.reference_path())):
        xs = [a.clone().requires_grad_() for a in leaves]
        with ctx:
            out = ops.attn_block(xs[0], *xs[1:], mask, math.sqrt(C // H), H)
        got = torch.autograd.grad(out, xs, dy)
        dw = got[3]
        print(f"keyprobe attn_block [64,{L},{C}] h{H} fp32 {label} vs "
              f"float64: dx {_rel(got[0], ref[0]):.3e}, dw q|k|v "
              + " | ".join(f"{_rel(dw[:, i:i + C], ref[3][:, i:i + C]):.3e}"
                           for i in range(0, 3 * C, C))
              + f", dgamma {_rel(got[1], ref[1]):.3e}, out "
              f"{_rel(out, _f64_attn_block(*leaves, mask, H)):.3e}",
              flush=True)
    del out, ref, got
    gc_collect()
    F = 4 * C
    xf = t(BATCH * L, C)
    fl = [xf, 1.0 + 0.1 * t(C), 0.1 * t(C), t(C, F, scale=C ** -0.5),
          0.1 * t(F), t(F, C, scale=F ** -0.5), 0.1 * t(C)]
    dyf = t(BATCH * L, C)
    xs = [a.double().requires_grad_() for a in fl]
    ref = torch.autograd.grad(_f64_ffn(*xs), xs, dyf.double())
    for label, ctx in (("kernel", contextlib.nullcontext()),
                       ("plain", ops.reference_path())):
        xs = [a.clone().requires_grad_() for a in fl]
        with ctx:
            out = ops.ffn(*xs)
        got = torch.autograd.grad(out, xs, dyf)
        print(f"keyprobe ffn [{BATCH * L},{C}] fp32 {label} vs float64: "
              + ", ".join(f"{n} {_rel(a, r):.3e}" for n, a, r in zip(
                  ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"),
                  got, ref)), flush=True)


# the wrappers put on their plain versions, a group at a time, by trunkprobe
TRUNKPROBE_SWAPS = (("swin_attention",), ("swin_mlp",),
                    ("swin_attention", "swin_mlp"), ("dropout_masks",),
                    ("umse", "attn_block", "ffn"))


def trunkprobe(power: str) -> None:
    """The bf16 step gate of --img-pretrain No (phase 19's pretrain_no
    step at dropout 0.1, its weights and first batch): the kernel path,
    the plain path and the kernel path with each of TRUNKPROBE_SWAPS on
    its plain version, each against the fp32 plain step, as
    _check_step_parity reads them: median and largest over every
    tensor, over the trunk's (img_encoder.) and over the rest. Then
    both paths from the weights nudged by half a bf16 rounding (every
    float entry times 1 +- 2**-9, seeded signs; the fp32 plain step from
    the same nudged weights), twice: each path's own spread."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    name = "pretrain_no"
    cfg = parse_config(BASELINES[name])
    batch = synthetic_batch(cfg, BATCH, seed=10,
                            present_frac=TRAIN_BATCHES[name][0])
    state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    c32 = cfg.replace(precision="fp32", dropout=0.1)
    c = cfg.replace(precision="bf16", dropout=0.1)

    def read(label, weights, plain, fp32):
        got = _train_run(c, weights, batch, plain)[1]
        errs = _step_errors(got, fp32)
        trunk = [e for n, e in errs.items() if n.startswith("img_encoder.")]
        rest = [e for n, e in errs.items()
                if not n.startswith("img_encoder.")]
        print(f"trunkprobe {name} bf16 dropout 0.1 ({power}): {label} vs "
              f"the fp32 plain step: {_summary(errs)}; trunk "
              f"({len(trunk)}) median {statistics.median(trunk):.3e} max "
              f"{max(trunk):.3e}; the rest ({len(rest)}) median "
              f"{statistics.median(rest):.3e} max {max(rest):.3e}",
              flush=True)
        del got
        gc_collect()

    fp32 = _train_run(c32, state, batch, True)[1]
    for label, plain in [("kernel path", False), ("plain path", True)] + [
            (" + ".join(s) + " plain", s) for s in TRUNKPROBE_SWAPS]:
        read(label, state, plain, fp32)
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        nudged = {k: (v * (1 + 2.0 ** -9 * (2 * torch.randint(
                      0, 2, v.shape, generator=g) - 1))).to(v.dtype)
                  if v.is_floating_point() else v
                  for k, v in state.items()}
        ref = _train_run(c32, nudged, batch, True)[1]
        for label, plain in (("kernel path", False), ("plain path", True)):
            read(f"{label}, weights nudged (seed {seed})", nudged, plain,
                 ref)
        del ref
        gc_collect()


# phase 14 under --mp-size 2 --dp-size 1: the drivers' bodies in two ranks
# on the one card over gloo, config 4 at full width and TP_LAYERS layers,
# 1 epoch of 2 train, 1 val and 1 test wire-format batches, an epoch
# save, a resume and the test driver
TP_DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "tp_driver_smoke")
TP_DRIVER_ARGV = CONFIG4 + ["--img-pack-frac", "0.55", "--epochs", "1",
                            "--log-iter", "1", "--dir-result",
                            TP_DRIVER_DIR, "--project-name", "tp_drivers",
                            "--mp-size", "2", "--dp-size", "1",
                            "--transformer-num-layers", str(TP_LAYERS)]
TP_DRIVER_BATCHES = {"train": [0.5, 0.75], "val": [0.5], "test": [0.25]}


def tp_driver_rank(out_dir: str) -> None:
    """One rank of the TP drivers' phase (started by parallel.launch): the
    train driver's set-up (common.setup_distributed: the group over gloo,
    the ranks sharing cuda:0, the mesh), its fold, the fold again under
    --resume last, the test driver's walk; rank 0 writes its results and
    the best checkpoint's eval probabilities on the test batch."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import common
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.logger import \
        make_setting_file
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parse_config(TP_DRIVER_ARGV)
    dev, mesh = common.setup_distributed(cfg)
    rank = mesh.rank
    wire, _, table = _driver_loaders(cfg, TP_DRIVER_BATCHES)
    loaders = lambda: [BatchList(wire[k]) for k in ("train", "val", "test")]
    make_setting_file(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    val, test = train_drv.run_fold(cfg, 0, *loaders(), txt_table=table,
                                   device=dev, mesh=mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(ops.launches)
    rcfg = cfg.replace(resume="last")
    rval, rtest = train_drv.run_fold(rcfg, 0, *loaders(), txt_table=table,
                                     device=dev, mesh=mesh)
    walked = test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                      loaders()[2], table, dev, mesh)
    best = ckpt.ckpt_path(TP_DRIVER_DIR, cfg.project_name, "best", 0,
                          cfg.seed)
    ev = Trainer(cfg, get_model(cfg), dev, eval_only=True, mesh=mesh,
                 txt_table=table)
    ckpt.restore(ev, ckpt.load_checkpoint(best), with_optimizer=False)
    probs = ev.eval_step(wire["test"][0])[0]
    if rank == 0:
        torch.save({"counts": counts, "run_s": run_s, "val": val,
                    "test": test, "resumed_val": rval,
                    "resumed_test": rtest, "walked": walked, "probs": probs,
                    "best": best},
                   os.path.join(out_dir, "rank0.pt"))


def run_tp_drivers(power: str) -> None:
    """Phase 14 under --mp-size 2 --dp-size 1: two ranks of tp_driver_rank
    through parallel.launch. Checks each rank's launch counts over the
    fold (config 4's TP launches per train and eval step), the run record
    rank 0 wrote (train losses at every step, a validation block,
    settings.txt, last and best, and nothing else of the run in the
    directory), the resumed run's validation at its step, the test
    driver's walk to the fold's final test metrics exactly; and rank 0's
    best checkpoint, the whole model in the single-process layout, loaded
    into a single-process Trainer: its eval probabilities on the test
    batch against the TP ranks' within phase 13's bound (PROB_TOL bf16).
    Prints rank 0's ms/step from the events' clock (TP_LABEL)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    shutil.rmtree(TP_DRIVER_DIR, ignore_errors=True)
    os.makedirs(TP_DRIVER_DIR)
    out = os.path.join(TP_DRIVER_DIR, "ranks")
    os.makedirs(out)
    launch("chip_smoke:tp_driver_rank", 2, f"file://{out}/rendezvous", [out],
           timeout=900)
    r0 = torch.load(os.path.join(out, "rank0.pt"), weights_only=False)
    n_train = len(TP_DRIVER_BATCHES["train"])
    n_eval = len(TP_DRIVER_BATCHES["val"]) + len(TP_DRIVER_BATCHES["test"])
    print(f"tp drivers: rank 0 launches over {n_train} train and {n_eval} "
          f"eval steps: {r0['counts']}; val {r0['val']}; test {r0['test']}; "
          f"resumed test {r0['resumed_test']}")
    for kernel in ops.KERNELS:
        want = (n_train * TP_TRAIN_LAUNCHES.get(kernel, 0)
                + n_eval * TP_EVAL_LAUNCHES.get(kernel, 0))
        if r0["counts"][kernel] != want:
            raise AssertionError(f"tp drivers {kernel}: "
                                 f"{r0['counts'][kernel]}, expected {want}")
    cfg = parse_config(TP_DRIVER_ARGV)
    root = os.path.join(TP_DRIVER_DIR, cfg.project_name)
    events = _events(os.path.join(root, "logs_0", "events.jsonl"))
    losses = [e for e in events if e["tag"] == "train/loss"]
    vals = [e["step"] for e in events if e["tag"] == "val/loss"]
    if ([e["step"] for e in losses] != list(range(1, 2 * n_train + 1))
            or not all(np.isfinite(e["value"]) for e in losses)
            or vals != [n_train, 2 * n_train]):
        raise AssertionError(f"tp drivers: events {losses} {vals}")
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs
                   if "tfevents" not in f)
    want_files = sorted(["settings.txt", "logs_0/events.jsonl",
                         f"ckpts/best_fold0_seed{cfg.seed}.pth",
                         f"ckpts/last_fold0_seed{cfg.seed}.pth"])
    got_walk = dict(r0["walked"]).get(r0["best"])
    print(f"tp drivers: files {files}; test driver walk {got_walk}")
    if files != want_files or got_walk != r0["resumed_test"]:
        raise AssertionError(f"tp drivers: files {files}, walk {got_walk} "
                             f"vs {r0['resumed_test']}")
    t = [e["t"] for e in losses]
    step_ms = [1e3 * (t[i] - t[i - 1]) for i in range(1, n_train)]
    print(f"tp drivers rank 0 train step ({power}; {TP_LABEL}): "
          f"{[round(x, 1) for x in step_ms]} ms/step (events clock); the "
          f"first fold {r0['run_s']:.1f} s")
    single = cfg.replace(mp_size=0, dp_size=0)
    wire, _, table = _driver_loaders(single, TP_DRIVER_BATCHES)
    ev = Trainer(single, get_model(single), torch.device("cuda"),
                 eval_only=True, txt_table=table)
    pay = ckpt.load_checkpoint(r0["best"])
    ckpt.restore(ev, pay, with_optimizer=False)
    probs = ev.eval_step(wire["test"][0])[0]
    d = float(np.max(np.abs(probs - r0["probs"])))
    print(f"tp drivers: rank 0's best checkpoint (step {pay['step']}) in a "
          f"single-process Trainer: max |prob - TP prob| {d:.3e} (tol "
          f"{PROB_TOL['bf16']})")
    if not np.all(np.isfinite(probs)) or d > PROB_TOL["bf16"]:
        raise AssertionError("tp drivers: the checkpoint scores apart in "
                             "one process")
    print(f"tp drivers phase ({power}): {time.perf_counter() - t_phase:.1f} "
          "s")


# ---------------------------------------------------------------------------
# phase 20: the legacy families of register_legacy at full width,
# bf16: the carryforward grid (window 24, 16 channels, the demographics;
# under --auxiliary-loss-input the 36-row pretrain windows and their
# f_indices), d 256, 4 heads, 6 layers, BioBERT notes 128 x 768, CXRs at
# 224 through the default Swin-T (trainable: stochastic depth in training
# mode), each image archetype once more on ResNet-18 and the GRU-D mid
# fusion on ResNet-50 (no uni-image name builds it), the image classifiers
# on their own backbones (ResNet-18, ViT-B/16, MaxViT, Swin-T, the patch
# stem), the MBT aliases on config 4's flags
LG_FLAGS = ["--vslt-type", "carryforward", "--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--batch-size", str(BATCH)]
LG_PRETRAIN = ["--auxiliary-loss-input", "directInput"]


def _lg(model, inputs, *extra):
    return ["--model", model, "--input-types", inputs] + LG_FLAGS + list(
        extra)


def _on_config4(model):
    return [a if a != "tri_mbt_vsltcls" else model for a in CONFIG4]


# run -> (argv, --auxiliary-loss-type: the auxcpc family's loss, which
# the command line does not take, else None). Every wiring meets each
# loss: predict (early cpc, early2 cosine, grudtxt l2, mbt cpc + Wbrl),
# direct (early l2, grudtxt cpc, mbt cosine), ct (early cosine, grudtxt
# l2, mbt cpc, which no ct file computes: 0)
LEGACY_RUNS = {
    **{n: (_lg(n, "vslt"), None) for n in (
        "binary_t_transformer", "binary_f_transformer",
        "multi_ft_transformer", "binary_gru_d", "binary_lstm",
        "binary_gru_d_t_transformer")},
    **{n: (_lg(n, "vslt_img"), None) for n in (
        "resnet", "swin_transformer", "vit", "vit_monai", "maxvit",
        "earlyfusion_img_vslt",
        "latefusion_img_trans_vslt_grud", "latefusion_img_trans_vslt_ttrans",
        "midfusion_img_trans_vslt_grud", "midfusion_img_trans_vslt_ttrans",
        "cross_transformer_img_vslt_sssccc")},
    **{f"{n}/resnet18": (_lg(n, "vslt_img", "--img-model-type", "resnet18"),
                         None) for n in (
        "earlyfusion_img_vslt", "latefusion_img_trans_vslt_ttrans",
        "midfusion_img_trans_vslt_ttrans",
        "cross_transformer_img_vslt_sssccc")},
    "midfusion_img_trans_vslt_grud/resnet50": (
        _lg("midfusion_img_trans_vslt_grud", "vslt_img", "--img-model-type",
            "resnet50"), None),
    **{n: (_lg(n, "vslt_txt"), None) for n in (
        "earlyfusion_vslt_txt_transformer", "latefusion_vslt_txt_transformer",
        "latefusion_vslt_grud_txt_transformer",
        "midfusion_vslt_txt_transformer", "bi_cross_transformer_txt_vslt")},
    "earlyfusion_img_txt_vslt": (_lg("earlyfusion_img_txt_vslt",
                                     "vslt_img_txt"), None),
    **{n: (_on_config4(n), None) for n in ("mbt_v1", "mbt_v2")},
    **{n: (_lg(n, "vslt_txt", *LG_PRETRAIN), loss) for n, loss in (
        ("auxcpc_early", "cpc"), ("auxcpc_early2", "cosine"),
        ("auxcpc_grudtxt", "l2"), ("auxcpc_mbt", "cpcWbrl"),
        ("auxcpc_early_direct", "l2"), ("auxcpc_grudtxt_dir", "cpc"),
        ("auxcpc_mbt_direct", "cosine"), ("auxcpc_early_ct", "cosine"),
        ("auxcpc_grudtxt_ct", "l2"), ("auxcpc_mbt_ct", "cpc"))},
}
# one representative per archetype, timed in turns with the plain path and
# profiled
LEGACY_TIMED = ("binary_t_transformer", "binary_f_transformer",
                "multi_ft_transformer", "binary_gru_d_t_transformer",
                "earlyfusion_img_txt_vslt", "midfusion_img_trans_vslt_ttrans",
                "latefusion_img_trans_vslt_grud",
                "cross_transformer_img_vslt_sssccc", "auxcpc_early",
                "auxcpc_mbt", "midfusion_img_trans_vslt_grud/resnet50",
                "vit", "maxvit")


def _lg_counts(enc=0, cross=0, masks=0, swin=False, bwd=None):
    """(eval, train, recomputes) of a legacy run's step: ``enc`` encoder
    layers (an attn_block and an ffn each), ``cross`` cross layers (an
    attention and an ffn each), the train step's input-dropout masks
    (``masks``), the trainable Swin-T (``swin``: 12 / 12 launches in eval;
    in train 12 window attentions, the MLP of block 0 alone and 22
    stochastic-depth masks, the backward kernels 12 + 1, no plain
    recompute); a backward for each layer the loss reaches (``bwd`` of the
    encoder layers where it reaches fewer)."""
    ev = {"attn_block": enc, "ffn": enc + cross, "attention": cross}
    if swin:
        ev.update(swin_attention=12, swin_mlp=12)
    tr = dict(ev, attn_block_bwd=enc if bwd is None else bwd,
              ffn_bwd=(enc if bwd is None else bwd) + cross,
              attention_bwd=cross, dropout_masks=masks + 22 * swin)
    if swin:
        tr.update(swin_mlp=1, **BL_SWIN_BWD)
    return ({k: v for k, v in ev.items() if v},
            {k: v for k, v in tr.items() if v}, {})


# the launches per step of each run (derived on the CPU by counting the
# ops calls and the backwards autograd runs through their outputs, batch
# 2, the same flags): the time and feature encoders 6 layers each with
# an input dropout, GRU-D / LSTM / ResNet / ViT / MaxViT / the patch stem
# no kernel (the LSTM features' fixed dropout one mask), the early fusion
# one joint encoder, the cross transformer 3 self layers per stream and 3
# cross layers per direction (no input dropout), AUXCPC's early fusion 6
# layers (no input dropout; the ct mirror 6 more), its MBT fusion 2
# streams x 6 (an input dropout per stream; under ct a mirror pass as
# many, whose layers the cpc loss, 0, does not reach)
_LG_ARCH = {
    "binary_t_transformer": _lg_counts(6, masks=1),
    "binary_f_transformer": _lg_counts(6, masks=1),
    "multi_ft_transformer": _lg_counts(12, masks=2),
    "binary_gru_d": _lg_counts(), "binary_lstm": _lg_counts(masks=1),
    "binary_gru_d_t_transformer": _lg_counts(6, masks=1),
    "resnet": _lg_counts(), "swin_transformer": _lg_counts(swin=True),
    "earlyfusion_img_vslt": _lg_counts(6, masks=1, swin=True),
    "latefusion_img_trans_vslt_grud": _lg_counts(swin=True),
    "latefusion_img_trans_vslt_ttrans": _lg_counts(6, masks=1, swin=True),
    "cross_transformer_img_vslt_sssccc": _lg_counts(6, 6, swin=True),
    "earlyfusion_img_vslt/resnet18": _lg_counts(6, masks=1),
    "cross_transformer_img_vslt_sssccc/resnet18": _lg_counts(6, 6),
    "auxcpc_early": _lg_counts(6), "auxcpc_mbt": _lg_counts(12, masks=2),
    "auxcpc_early_ct": _lg_counts(12),
    "auxcpc_mbt_ct": _lg_counts(24, masks=4, bwd=12),
}
for _run, _like in {
        "vit": "resnet", "vit_monai": "resnet",
        "maxvit": "resnet", "midfusion_img_trans_vslt_grud/resnet50": "resnet",
        "latefusion_vslt_grud_txt_transformer": "resnet",
        "earlyfusion_img_txt_vslt": "earlyfusion_img_vslt",
        "midfusion_img_trans_vslt_grud": "latefusion_img_trans_vslt_grud",
        "midfusion_img_trans_vslt_ttrans":
            "latefusion_img_trans_vslt_ttrans",
        "latefusion_img_trans_vslt_ttrans/resnet18":
            "earlyfusion_img_vslt/resnet18",
        "midfusion_img_trans_vslt_ttrans/resnet18":
            "earlyfusion_img_vslt/resnet18",
        "earlyfusion_vslt_txt_transformer": "earlyfusion_img_vslt/resnet18",
        "latefusion_vslt_txt_transformer": "earlyfusion_img_vslt/resnet18",
        "midfusion_vslt_txt_transformer": "earlyfusion_img_vslt/resnet18",
        "bi_cross_transformer_txt_vslt":
            "cross_transformer_img_vslt_sssccc/resnet18",
        "auxcpc_early2": "auxcpc_early", "auxcpc_grudtxt": "auxcpc_early",
        "auxcpc_early_direct": "auxcpc_early",
        "auxcpc_grudtxt_dir": "auxcpc_early",
        "auxcpc_mbt_direct": "auxcpc_mbt",
        "auxcpc_grudtxt_ct": "auxcpc_early_ct"}.items():
    _LG_ARCH[_run] = _LG_ARCH[_like]
# the MBT aliases: config 4's and tri_mbt_v1's launches (phases 4b, 7, 15)
for _run, _train in (("mbt_v1", "tri_v1"), ("mbt_v2", "config4")):
    _LG_ARCH[_run] = (LAUNCHES_PER_STEP["config4"],
                      {k: v for k, v in TRAIN_LAUNCHES_PER_STEP[_train]
                       .items() if v}, {})
LEGACY_EVAL = {r: c[0] for r, c in _LG_ARCH.items()}
LEGACY_TRAIN = {r: c[1] for r, c in _LG_ARCH.items()}
LEGACY_RECOMPUTE = {r: c[2] for r, c in _LG_ARCH.items()}
if set(_LG_ARCH) != set(LEGACY_RUNS):
    raise AssertionError("phase 20's launch tables miss a run")
# the names of the train paths whose launches the kernels line lists
LG_PATHS = {f"lg:{r}": f"{r} train" for r in LEGACY_RUNS}
# the runs' tensors with a zero true gradient beside ZERO_GRAD's: the late
# fusion's LayerNorm biases and its heads' first biases (each head's
# BatchNorm cancels them), the key biases of the ViT's and MaxViT's
# attention (softmax is shift invariant per query)
LG_ZERO_GRAD = ("v_ln.bias", "o_ln.bias", "fc_vslt.0.bias",
                "fc_other.0.bias", ".key.bias")
# the image cross transformers' tensors whose gradient reaches the loss
# only through the scores of an attention over the 49 image tokens (the
# image stream's self layers self_o_i and the vslt stream's cross layers
# cross_v_i: the q and k projections, a cross layer's query pre-norm).
# Those tokens are the same within a sample without a CXR and nearly so
# with one, so the scores carry little gradient (dq 1e-3 of dv with a CXR,
# 1e-7 without; legacyprobe). They stay in the fp32 gate. In bf16 the
# kernels take delta from the bf16 output, as the TPU kernels do (JAX
# kernels/attention.py:358), which leaves dq many times its true norm
# there (ROADMAP Queue 2 item 2): each such tensor is held, in absolute
# terms, to the bf16 rounding the plain path makes on the same layer's
# value projection (StepAllowance.bf16_held), the weight against its
# weight, a vector against its bias
_V = "self_attention.value_proj.linear."
_QK = (("self_attention.query_proj.linear.weight", _V + "weight"),
       ("self_attention.query_proj.linear.bias", _V + "bias"),
       ("self_attention.key_proj.linear.weight", _V + "weight"))
LG_CROSS_IMG_HELD = tuple(
    [(f"self_o_{i}.{t}", f"self_o_{i}.{r}") for i in range(3)
     for t, r in _QK]
    + [(f"cross_v_{i}.{t}", f"cross_v_{i}.{r}") for i in range(3)
       for t, r in _QK + (("attention_prenorm_q.gamma", _V + "bias"),
                          ("attention_prenorm_q.beta", _V + "bias"))])
# phase 20's step allowances by run (StepAllowance); every other run, and
# every earlier phase, meets phase 15's step gates alone. The auxcpc runs:
# losses to 1.75e5 and ct_weight to +-22.6 at the reference's init. The
# ttrans mid fusion on Swin-T: a ReLU pre-activation 9.3e-6 from 0
# feeds its BatchNorm head (relu(merge)), and its flip moves every fp32
# tensor by 2-3e-2 on either path. auxcpc_early: its last FFN bias
# reaches the loss through the head's BatchNorm, which cancels it, and a
# cpc softmax at saturation, so its fp32 gradient is rounding
LG_ALLOW = {
    **{r: StepAllowance(loss_relative=True, ulp_params=("ct_weight",))
       for r in LEGACY_RUNS if r.startswith("auxcpc_")},
    "auxcpc_early": StepAllowance(loss_relative=True,
                                  ulp_params=("ct_weight",),
                                  noise_floor=True),
    "midfusion_img_trans_vslt_ttrans": StepAllowance(noise_floor=True),
    **{r: StepAllowance(bf16_held=LG_CROSS_IMG_HELD) for r in LEGACY_RUNS
       if r.startswith("cross_transformer_img")},
}


def _lg_cfg(run: str):
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    argv, loss = LEGACY_RUNS[run]
    cfg = parse_config(argv)
    return cfg.replace(auxiliary_loss_type=loss) if loss else cfg


def compare_legacy_kernels() -> dict:
    """The kernels at the shapes only the legacy families give them, fp32
    and bf16, against the plain versions (TOL, GRAD_TOL; in bf16 the
    profiler's device ms per form and the route's kernels): the masked
    attention of the image cross transformer's cross layers, vslt queries
    [64, 24, 4, 64] against the Swin-T's 49 image keys (every key valid:
    a key mask with none masked) and back, beside
    scaled_dot_product_attention; attn_block at the early fusion's joint
    stream at tri on Swin-T, [64, 202, 256] (cls, 24 vslt rows, 49 image
    rows always valid, 128 note rows, the vslt and note tails masked), and
    at the time transformer's [64, 25, 256] under its key mask. Returns
    the bf16 results by kernel name (attention: the vslt queries'
    direction; attn_block: the joint stream) and the rest by shape."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
        attention_route
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
        attn_block_route, key_ends)
    from medical_tri_modal_pilot_tpu_torch.models.modules import \
        length_key_mask
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(19)
    D, H, Dh = 256, 4, 64
    results, extra = {}, {}
    for name, Lq, Lk, kind in (("cross_img_v", 24, 49, "img"),
                               ("cross_img_o", 49, 24, "vslt")):
        q, k, v, mask, is_self, live = _attention_case(g, dev, BATCH, H, Lq,
                                                       Lk, Dh, kind)
        shape = f"q[{BATCH},{Lq},{H},{Dh}] kv[{BATCH},{Lk},{H},{Dh}]"
        tag = f"attention {name} {shape}"
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            cot = torch.randn(BATCH, Lq, H, Dh, generator=g).to(dev).to(dt)
            fwd = (lambda *a, m=mask: ops.attention(*a, m, Dh ** .5, False))
            work_f = _attention_work(qd, kd, mask, False)
            work_b = _attention_work(qd, kd, mask, False, backward=True)
            if dt == torch.float32:
                with torch.inference_mode():
                    _compare(tag, dt, lambda: fwd(qd, kd, vd), work_f, live)
                _compare_train(tag, dt, fwd, (qd, kd, vd), cot, live, work_f,
                               work_b)
                continue
            lr, fr, br = _train_forms(
                tag, dt, fwd, (qd, kd, vd), cot, live, work_f, work_b,
                ATTN_ROUTE_KERNELS, attention_route(dt, Dh),
                library=_sdpa_library(qd, kd, vd, mask, cot))
            res = {"attention": dict(lr, shape=shape, train=fr),
                   "attention_bwd": dict(br, shape=shape)}
            if name == "cross_img_v":
                results.update(res)
            else:
                extra[name] = res
    vslt = torch.randint(1, 25, (BATCH,), generator=g)
    txt = (torch.randint(0, 129, (BATCH,), generator=g) + 2).clamp(1, 128)
    txt[:2] = torch.tensor([2, 128])
    joint = torch.cat([torch.zeros(BATCH, 1, dtype=torch.bool),
                       length_key_mask(vslt, 24),
                       torch.zeros(BATCH, 49, dtype=torch.bool),
                       length_key_mask(txt, 128)], 1).to(dev)
    time_mask = length_key_mask(vslt + 1, 25).to(dev)
    gamma, beta = (1 + .1 * torch.randn(D, generator=g)).to(dev), \
        (.1 * torch.randn(D, generator=g)).to(dev)
    w = (torch.randn(D, 3 * D, generator=g) * D ** -.5).to(dev)
    b = (.1 * torch.randn(3 * D, generator=g)).to(dev)
    for name, mask in (("early_tri", joint), ("t_transformer", time_mask)):
        L = mask.shape[1]
        ends = key_ends(mask).long()
        live = torch.arange(L, device=dev)[None, :] < ends[:, None]
        shape = f"[{BATCH},{L},{D}]"
        tag = f"attn_block{shape} {name}"
        for dt in (torch.float32, torch.bfloat16):
            es = 2 if dt == torch.bfloat16 else 4
            x = torch.randn(BATCH, L, D, generator=g).to(dev).to(dt)
            cot = torch.randn(BATCH, L, D, generator=g).to(dev).to(dt) \
                * live[:, :, None]
            work_f, work_b = _attn_block_work(L, D, H, es, ends.double().cpu())
            fwd = (lambda *a, m=mask: ops.attn_block(*a, m, (D // H) ** .5, H))
            inputs = (x, gamma, beta, w.to(dt), b.to(dt))
            if dt == torch.float32:
                with torch.inference_mode():
                    _compare(tag, dt, lambda: fwd(*inputs), work_f, live)
                _compare_train(tag, dt, fwd, inputs, cot, live, work_f,
                               work_b)
                continue
            lr, fr, br = _train_forms(tag, dt, fwd, inputs, cot, live,
                                      work_f, work_b,
                                      ATTN_BLOCK_ROUTE_KERNELS,
                                      attn_block_route(dt, D, H))
            res = {"attn_block": dict(lr, shape=shape, train=fr),
                   "attn_block_bwd": dict(br, shape=shape)}
            if name == "early_tri":
                results.update(res)
            else:
                extra[name] = res
    for kernel, res in results.items():
        res["other_shapes"] = {n: r[kernel] for n, r in extra.items()
                               if kernel in r}
    return results


def _legacy_run(run: str, power: str, timed: bool) -> dict:
    """One legacy run at full width, bf16: an eval step (its launches
    against LEGACY_EVAL, reset just before and read just after), its
    probabilities against the plain path's in bf16 and, on the same
    weights, in fp32 (PROB_TOL); a train step at --dropout 0.1 (launches
    against LEGACY_TRAIN, no plain recompute (LEGACY_RECOMPUTE),
    a finite loss, peak memory); with ``timed`` eval and train ms/step on
    both paths in turns and a profiled train step (device busy, idle
    share); then one step from the same weights on both paths in fp32 and
    bf16 at dropout 0 (phase 15's step gates, LG_ALLOW's allowances).
    Returns the train step's launches."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda")
    cfg = _lg_cfg(run)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.precision, cfg.dropout,
              cfg.image_size)
    if widths != (256, 6, 4, "bf16", 0.1, 224):
        raise AssertionError(f"{run} defaults changed: {widths}")
    batch = synthetic_batch(cfg, BATCH, seed=20, present_frac=0.5)
    model = get_model(cfg, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, dev, eval_only=True)
    ops.reset_launches()
    probs, _, _ = _eval_steps(trainer, [batch])
    torch.cuda.synchronize()
    ev = {k: v for k, v in ops.launches.items() if v}
    if ev != LEGACY_EVAL[run]:
        raise AssertionError(f"{run} eval launches {ev}, expected "
                             f"{LEGACY_EVAL[run]}")
    if probs.shape != (BATCH,) or not np.all(np.isfinite(probs)):
        raise AssertionError(f"{run}: bad probabilities {probs.shape}")
    with ops.reference_path():
        ref, _, _ = _eval_steps(trainer, [batch])
    d16 = float(np.max(np.abs(probs - ref)))
    eval_ms = None
    if timed:
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_ms(trainer, [batch] * 2, reference))
        eval_ms = (np.mean(ms[False]), np.mean(ms[True]))
    del trainer, model
    tr32 = Trainer(cfg.replace(precision="fp32"),
                   get_model(cfg.replace(precision="fp32"), state=state),
                   dev, eval_only=True)
    p32, _, _ = _eval_steps(tr32, [batch])
    with ops.reference_path():
        r32, _, _ = _eval_steps(tr32, [batch])
    d32 = float(np.max(np.abs(p32 - r32)))
    del tr32
    print(f"{run}: eval launches {ev}; max |prob - plain prob| bf16 "
          f"{d16:.3e} (tol {PROB_TOL['bf16']}), fp32 {d32:.3e} (tol "
          f"{PROB_TOL['fp32']})")
    if d16 > PROB_TOL["bf16"] or d32 > PROB_TOL["fp32"]:
        raise AssertionError(f"{run}: the kernel path's eval disagrees "
                             "with the plain path")

    model = get_model(cfg, state=state)
    tr = Trainer(cfg, model, dev, eval_only=False, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    loss = tr.train_step(batch)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    recomputes = {k: v for k, v in ops.recomputes.items() if v}
    peak = torch.cuda.max_memory_allocated()
    got = {k: v for k, v in counts.items() if v}
    print(f"{run}: train launches {got}, recomputes {recomputes}; loss "
          f"{loss:.5f}; peak device memory {peak / 2 ** 30:.3f} GiB "
          f"(before the step {base / 2 ** 30:.3f} GiB)")
    if got != LEGACY_TRAIN[run]:
        raise AssertionError(f"{run} train launches {got}, expected "
                             f"{LEGACY_TRAIN[run]}")
    if recomputes != LEGACY_RECOMPUTE.get(run, {}):
        raise AssertionError(f"{run} train recomputes {recomputes}")
    if not np.isfinite(loss):
        raise AssertionError(f"{run}: non-finite train loss")
    if timed:
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_train_ms(tr, [batch] * 2,
                                                 reference))
        kernel_ms, plain_ms = np.mean(ms[False]), np.mean(ms[True])
        TRAIN_STEP_MS[run] = kernel_ms
        print(f"{run} ({power}): eval kernels {eval_ms[0]:.2f} ms/step, "
              f"plain {eval_ms[1]:.2f}; train kernels {kernel_ms:.2f} "
              f"ms/step ({BATCH * 1e3 / kernel_ms:.1f} samples/s), plain "
              f"{plain_ms:.2f}; rounds {ms[False]} / {ms[True]}; launches "
              f"per train step {sum(got.values())}")
        _profile_step(run, tr, batch, power, train=True)
    del tr, model
    torch.cuda.empty_cache()
    _check_step_parity(run, cfg, state, batch,
                       [("fp32", 0.0), ("bf16", 0.0)], LG_ZERO_GRAD,
                       LG_ALLOW.get(run))
    return counts


def legacyprobe(power: str) -> None:
    """The bf16 step of the image cross transformer at dropout 0: each
    masked attention call of one kernel-path step, its inputs and its
    output's cotangent recorded, then its dq, dk, dv by the kernel, by the
    plain path in bf16 and by the plain path in fp32 on the same inputs;
    each bf16 path's |err|_F / |fp32|_F per call and operand, over the
    samples with a CXR and those without."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    cfg = _lg_cfg("cross_transformer_img_vslt_sssccc").replace(dropout=0.0)
    batch = synthetic_batch(cfg, BATCH, seed=20, present_frac=0.5)
    model = get_model(cfg, torch.Generator().manual_seed(0))
    tr = Trainer(cfg, model, torch.device("cuda"), eval_only=False, seed=0)
    calls, real = [], ops.attention

    def record(q, k, v, mask, scale, is_self=False):
        out = real(q, k, v, mask, scale, is_self)
        rec = [t.detach().clone() for t in (q, k, v)] + [mask, scale,
                                                          is_self]
        calls.append(rec)
        out.register_hook(lambda g: rec.append(g.detach().clone()))
        return out
    ops.attention = record
    try:
        tr.train_step(batch)
    finally:
        ops.attention = real
    present = torch.from_numpy(batch["missing"][:, 1] == 0).cuda()
    for i, (q, k, v, mask, scale, is_self, cot) in enumerate(calls):
        grads = {}
        for path in ("kernel", "plain", "fp32"):
            dt = torch.float32 if path == "fp32" else q.dtype
            leaves = [t.to(dt).requires_grad_(True) for t in (q, k, v)]
            with (ops.reference_path() if path != "kernel"
                  else contextlib.nullcontext()):
                out = ops.attention(*leaves, mask, scale, is_self)
            grads[path] = torch.autograd.grad(out, leaves, cot.to(dt))
        parts = []
        for name, j in (("dq", 0), ("dk", 1), ("dv", 2)):
            ref = grads["fp32"][j].float()
            for group, rows in (("cxr", present), ("none", ~present)):
                r = ref[rows]
                errs = [float((grads[p][j].float()[rows] - r).norm()
                              / r.norm().clamp_min(1e-30))
                        for p in ("kernel", "plain")]
                parts.append(f"{name} {group} |fp32| {float(r.norm()):.3e} "
                             f"kernel {errs[0]:.3e} plain {errs[1]:.3e}")
        print(f"legacyprobe ({power}) attention call {i} q{list(q.shape)} "
              f"kv{list(k.shape)}: " + "; ".join(parts))


def run_legacy(power: str, runs=()) -> tuple:
    """Phase 20: the legacy families at full width (LEGACY_RUNS, or the
    ``runs`` named): the kernels at the shapes only they give
    (compare_legacy_kernels), then every run (_legacy_run); the refusals
    that stay. Returns (those kernel results, each run's train launches
    keyed as LG_PATHS)."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    t_phase = time.perf_counter()
    results = compare_legacy_kernels()
    counts = {}
    for run in runs or LEGACY_RUNS:
        t_run = time.perf_counter()
        counts[f"lg:{run}"] = _legacy_run(run, power, run in LEGACY_TIMED)
        gc_collect()
        print(f"{run}: {time.perf_counter() - t_run:.1f} s")
    try:
        get_model(parse_config(_lg("earlyfusion_img_vslt", "vslt_img",
                                   "--vslt-type", "TIE")))
    except NotImplementedError as e:
        print(f"earlyfusion_img_vslt --vslt-type TIE: refused, {e}")
    else:
        raise AssertionError("a legacy model took the TIE stream")
    print("legacy train step (" + power + "): " + ", ".join(
        f"{r} {TRAIN_STEP_MS[r]:.2f} ms/step" for r in LEGACY_TIMED
        if r in TRAIN_STEP_MS))
    print(f"legacy phase ({power}): {time.perf_counter() - t_phase:.1f} s")
    return results, counts


# ---------------------------------------------------------------------------
# phase 21: data parallelism. First the kernels that draw dropout masks at
# a data rank's row offset (row0); then config 4 at full width (bf16 and
# fp32, --dropout 0.1, adamw) through the drivers in two gloo ranks that
# share the card at --dp-size 2 (each computes on its half of every
# global batch), and in four at --dp-size 2 --mp-size 2 (TP_LAYERS
# layers), each against the single process on the same global batches
DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "dp_smoke")
DP_LABEL = ("ranks share one H100 over gloo, beside the other run's ranks: "
            "not a data-parallel speed figure")
# run -> (argv, ranks, batches' present-image fractions by split, eval and
# train launches per step and rank)
DP_RUNS = {
    "dp": (CONFIG4 + ["--dp-size", "2"], 2,
           {"train": [0.5, 0.25, 0.75, 0.5], "val": [0.5], "test": [0.75]},
           LAUNCHES_PER_STEP["config4"], TRAIN_LAUNCHES_PER_STEP["config4"]),
    "dp_mp": (CONFIG4 + ["--dp-size", "2", "--mp-size", "2",
                         "--transformer-num-layers", str(TP_LAYERS)], 4,
              {"train": [0.5, 0.75], "val": [0.5], "test": [0.25]},
              TP_EVAL_LAUNCHES, TP_TRAIN_LAUNCHES),
}
DP_PRECS = ("bf16", "fp32")
# fp32 gates of a dp run against the single process after its Adam steps
# (the two differ by the order of the gradient sums, which Adam turns into
# steps of up to lr on elements whose gradient is near 0): the test
# driver's largest probability difference, and the median and the largest
# over the tensors of |dp - single|_F / |single|_F of each first Adam
# moment and each parameter update; each set between the sound readings
# and those of two planted faults, a rank drawing the first rank's masks
# and BatchNorm on local statistics (PERF.md, section 6): sound
# probabilities 2.7e-4, faults 8.9e-2 and up; sound medians 7.1e-4 and
# below, faults 0.47 and up; sound largest 0.137 (an update whose
# gradient is near 0), faults 0.73 and up
DP_PROB_FP32 = 2e-3
DP_STATE_FP32 = {"median": 3e-2, "max": 0.3}
# the row-offset kernel forms: a data rank's half of the main path's
# [64 x 1024] vslt rows at C 256 (F 1024, and F 0: the input dropout's
# masks alone) and at the split route's C 512 (F 2048)
ROW0_SHAPES = ((256, 1024), (256, 0), (512, 2048))


def _dp_argv(run: str, prec: str, who: str):
    return DP_RUNS[run][0] + [
        "--precision", prec, "--dropout", "0.1", "--epochs", "1",
        "--log-iter", "1", "--img-pack-frac", "0.55",
        "--dir-result", os.path.join(DP_DIR, who),
        "--project-name", f"{run}_{prec}"]


@contextlib.contextmanager
def _recorded_probs():
    """Every probability an Evaluator is given meanwhile, in order."""
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    seen, add = [], Evaluator.add_batch

    def recorded(self, y_true, y_prob, *args, **kwargs):
        seen.append(np.asarray(y_prob, dtype=np.float64).reshape(-1))
        return add(self, y_true, y_prob, *args, **kwargs)
    Evaluator.add_batch = recorded
    try:
        yield seen
    finally:
        Evaluator.add_batch = add


def _dp_fold(cfg, splits, dev, mesh) -> dict:
    """The train driver's fold from seeded weights over the run's wire
    batches, then the test driver's walk over its checkpoints: the
    launches of the fold, its seconds and peak memory, the walk's
    probabilities and the last checkpoint's path."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import common
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    from medical_tri_modal_pilot_tpu_torch.train.logger import \
        make_setting_file
    wire, _, table = _driver_loaders(cfg, splits)
    loaders = lambda: [BatchList(wire[k]) for k in ("train", "val", "test")]
    make_setting_file(cfg)
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    common.set_seeds(cfg.seed)       # the model's seeded weights
    ops.reset_launches()
    t0 = time.perf_counter()
    train_drv.run_fold(cfg, 0, *loaders(), txt_table=table, device=dev,
                       mesh=mesh)
    torch.cuda.synchronize()
    res = {"run_s": time.perf_counter() - t0, "counts": dict(ops.launches),
           "peak": torch.cuda.max_memory_allocated()}
    with _recorded_probs() as probs:
        test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                 loaders()[2], table, dev, mesh)
    res["probs"] = np.concatenate(probs)
    res["last"] = ckpt.ckpt_path(cfg.dir_result, cfg.project_name, "last", 0,
                                 cfg.seed)
    return res


def dp_rank(out_dir: str, run: str) -> None:
    """One rank of phase 21's ``run`` (started by parallel.launch): the
    drivers' set-up (common.setup_distributed: gloo, every rank on cuda:0,
    the mesh), then _dp_fold at each of DP_PRECS; each rank writes its
    results to ``out_dir``/rank{r}.pt."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.drivers import common
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for prec in DP_PRECS:
        cfg = parse_config(_dp_argv(run, prec, "ranks"))
        dev, mesh = common.setup_distributed(cfg)
        if dev.type != "cuda":
            raise AssertionError(f"dp rank on {dev}")
        res[prec] = _dp_fold(cfg, DP_RUNS[run][2], dev, mesh)
        res[prec]["mesh"] = (mesh.dp, mesh.mp, mesh.rank)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def _dp_noise_floor(run: str, prec: str, want: np.ndarray) -> float:
    """The single process's own distance from its test driver
    probabilities ``want`` when its seeded weights carry STEP_NOISE of
    relative noise: the largest over STEP_NOISE_DRAWS draws of the walk's
    max |prob diff| (the folds in this process, no other change). After
    a few Adam steps a bf16 run amplifies a rounding-size difference in
    its state into probability differences of this order."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    build = train_drv.get_model
    floor = 0.0
    for draw in range(STEP_NOISE_DRAWS):
        g = torch.Generator().manual_seed(draw)

        def nudged(cfg, *args, **kwargs):
            model = build(cfg, *args, **kwargs)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + STEP_NOISE * torch.randn(
                        p.shape, generator=g, dtype=p.dtype))
            return model
        cfg = parse_config(_dp_argv(run, prec, f"noise{draw}")).replace(
            dp_size=0, mp_size=0)
        train_drv.get_model = nudged
        try:
            res = _dp_fold(cfg, DP_RUNS[run][2], torch.device("cuda"), None)
        finally:
            train_drv.get_model = build
        floor = max(floor, float(np.max(np.abs(res["probs"] - want))))
    return floor


def _dp_state(names, path) -> dict:
    """A checkpoint's trainable tensors by name (``names``, the
    optimizer's order): (first Adam moment, parameter), in fp32 on the
    card."""
    from medical_tri_modal_pilot_tpu_torch.train import checkpoints as ckpt
    pay = ckpt.load_checkpoint(path)
    dev = torch.device("cuda")
    return {n: (pay["optimizer"]["state"][i]["exp_avg"].float().to(dev),
                pay["model"][n].float().to(dev)) for i, n in enumerate(names)}


def _dp_events(cfg) -> list:
    root = os.path.join(cfg.dir_result, cfg.project_name)
    return [e for e in _events(os.path.join(root, "logs_0", "events.jsonl"))
            if e["tag"] == "train/loss"]


def _dp_errors(a: dict, b: dict, i: int, init=None) -> dict:
    """_step_errors of the checkpoints' entry ``i`` (0 the first Adam
    moment, 1 the parameter); with ``init``, of the parameters' updates
    from it: |a - b|_F / |b - init|_F per tensor."""
    if init is None:
        return _step_errors({n: (v[i], None) for n, v in a.items()},
                            {n: (v[i], None) for n, v in b.items()})
    return _step_errors({n: (v[i] - init[n], None) for n, v in a.items()},
                        {n: (v[i] - init[n], None) for n, v in b.items()})


def _dp_check(run: str, power: str, single: dict, ranks: list,
              scored: dict, floor: float) -> list:
    """Phase 21's gates for ``run``: per precision the loss of every step
    (STEP_LOSS_TOL), each rank's launches equal to the single process's
    and to the per-step tables, the test driver's probabilities against
    the single process's run (fp32 within DP_PROB_FP32; bf16 within
    PROB_TOL["bf16"], or past it within STEP_NOISE_RATIO of ``floor``, the
    single process's own distance under STEP_NOISE of weight noise,
    _dp_noise_floor) and against the single process scoring the ranks'
    own checkpoints (``scored``) within PROB_TOL of the precision (the
    eval path alone); the state after the steps by phase 7's Frobenius
    rules, the first Adam moments (the steps' gradients) and the
    parameters' updates from the seeded weights per tensor: fp32 |dp -
    single|_F / |single|_F at the median and the largest within
    DP_STATE_FP32, bf16 against the fp32
    single process within STEP_BF16_RATIO of the single process's bf16
    distance (+ 1e-2) at the median and the largest. Returns the
    failures."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.drivers.common import set_seeds
    _, nproc, splits, eval_pp, train_pp = DP_RUNS[run]
    n_train = len(splits["train"])
    n_eval = len(splits["val"]) + len(splits["test"])
    # the seeded initial weights (the same at both precisions) and the
    # trainable parameters' names in the optimizer's order
    cfg = parse_config(_dp_argv(run, DP_PRECS[0], "single")).replace(
        dp_size=0, mp_size=0)
    set_seeds(cfg.seed)
    init = {n: p.detach().float().cuda()
            for n, p in get_model(cfg).named_parameters() if p.requires_grad}
    names = list(init)
    failures, states = [], {}
    for prec in DP_PRECS:
        cfg = parse_config(_dp_argv(run, prec, "single")).replace(
            dp_size=0, mp_size=0)
        rcfg = parse_config(_dp_argv(run, prec, "ranks"))
        s, r0 = single[prec], ranks[0][prec]
        losses = [e["value"] for e in _dp_events(cfg)]
        got = [e["value"] for e in _dp_events(rcfg)]
        d_loss = max(abs(a - b) for a, b in zip(got, losses))
        want = {k: n_train * train_pp.get(k, 0) + n_eval * eval_pp.get(k, 0)
                for k in ops.KERNELS}
        bad = [(r, k) for r, res in enumerate(ranks) for k in ops.KERNELS
               if res[prec]["counts"][k] != want[k]]
        if run == "dp":
            bad += [("single", k) for k in ops.KERNELS
                    if s["counts"][k] != want[k]]
        d_prob = float(np.max(np.abs(r0["probs"] - s["probs"])))
        d_own = float(np.max(np.abs(r0["probs"] - scored[prec])))
        states[prec] = (_dp_state(names, s["last"]),
                        _dp_state(names, r0["last"]))
        one = states[prec][0]
        moved = max(float((one[n][1] - init[n]).abs().max()) for n in one)
        if prec == "fp32":
            prob_tol = DP_PROB_FP32
            prob_ok = d_prob <= prob_tol
        else:
            prob_tol = PROB_TOL["bf16"]
            prob_ok = d_prob <= prob_tol or d_prob <= STEP_NOISE_RATIO * floor
        print(f"dp {run} {prec}: losses {[round(x, 6) for x in got]} vs "
              f"single {[round(x, 6) for x in losses]} (max |diff| "
              f"{d_loss:.3e}, tol {STEP_LOSS_TOL[prec]}); test driver "
              f"probabilities max |diff| {d_prob:.3e} (tol {prob_tol}"
              + ("" if prec == "fp32" else
                 f", or {STEP_NOISE_RATIO}x the single process's "
                 f"{floor:.3e} under {STEP_NOISE} relative weight noise, "
                 f"the largest of {STEP_NOISE_DRAWS} draws")
              + f"; {prob_ok}) over {len(s['probs'])}, against the single "
              f"process scoring the ranks' checkpoints {d_own:.3e} (tol "
              f"{PROB_TOL[prec]}); launches per rank {r0['counts']} "
              f"(expected {want}; off: {bad}); parameters moved up to "
              f"{moved:.3e}")
        if len(got) != n_train or len(losses) != n_train or \
                not np.all(np.isfinite(got)) or d_loss > STEP_LOSS_TOL[prec]:
            failures.append(f"{run} {prec}: losses")
        if bad:
            failures.append(f"{run} {prec}: launches {bad[:4]}")
        if not np.all(np.isfinite(r0["probs"])) or not prob_ok or \
                d_own > PROB_TOL[prec] or \
                len(r0["probs"]) != len(s["probs"]) or not len(s["probs"]):
            failures.append(f"{run} {prec}: test probabilities")
        if moved == 0.0:
            failures.append(f"{run} {prec}: parameters did not move")
        for r, res in enumerate(ranks):
            print(f"dp {run} {prec} rank {r} ({power}; {DP_LABEL}): the "
                  f"fold {res[prec]['run_s']:.1f} s, peak device memory "
                  f"{res[prec]['peak'] / 2 ** 30:.3f} GiB; single process "
                  f"{s['run_s']:.1f} s, {s['peak'] / 2 ** 30:.3f} GiB")
        t1 = [e["t"] for e in _dp_events(rcfg)]
        t0 = [e["t"] for e in _dp_events(cfg)]
        ms = lambda t: [round(1e3 * (t[i] - t[i - 1]), 1)
                        for i in range(1, len(t))]
        print(f"dp {run} {prec} train ms/step (events clock; {power}; "
              f"{DP_LABEL}): rank 0 {ms(t1)}, single process alone {ms(t0)}")
    (one32, dp32), (one16, dp16) = states["fp32"], states["bf16"]
    for what, ref in (("first Adam moments", None),
                      ("parameter updates", init)):
        i = 0 if ref is None else 1
        e32 = _dp_errors(dp32, one32, i, ref)
        print(f"dp {run} fp32 {what} |dp - single|_F/|single|_F over "
              f"{len(e32)} tensors: {_summary(e32)} (tol {DP_STATE_FP32})")
        for stat in (statistics.median, max):
            if not stat(e32.values()) <= DP_STATE_FP32[stat.__name__]:
                failures.append(f"{run} fp32: {stat.__name__} {what}")
        k_err, p_err = (_dp_errors(dp16, one32, i, ref),
                        _dp_errors(one16, one32, i, ref))
        print(f"dp {run} bf16 {what} against the fp32 single process: dp "
              f"{_summary(k_err)}; single {_summary(p_err)} (within "
              f"{STEP_BF16_RATIO}x + 1e-2)")
        for stat in (statistics.median, max):
            if not stat(k_err.values()) <= STEP_BF16_RATIO * stat(
                    p_err.values()) + 1e-2:
                failures.append(f"{run} bf16: {stat.__name__} {what} "
                                "against fp32")
    return failures


def _dp_launch(run: str) -> list:
    """The ranks of dp_rank for ``run`` through parallel.launch; their
    results in rank order."""
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    nproc = DP_RUNS[run][1]
    out = os.path.join(DP_DIR, f"{run}_ranks")
    os.makedirs(out)
    t0 = time.perf_counter()
    launch("chip_smoke:dp_rank", nproc, f"file://{out}/rendezvous",
           [out, run], timeout=900)
    print(f"dp {run}: {nproc} ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(nproc)]


def run_dp(power: str) -> None:
    """Phase 21 (a) and (b): the single process's folds on the card for
    every run of DP_RUNS, alone; then the ranks of every run at once
    (_dp_launch, one thread each) while this process finds each run's bf16
    noise floor (_dp_noise_floor); then per run the ranks' checkpoints
    scored in this process and _dp_check; raises with every failure."""
    from concurrent.futures import ThreadPoolExecutor
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    t_phase = time.perf_counter()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    dev = torch.device("cuda")
    single = {}
    for run, (_, _, splits, _, _) in DP_RUNS.items():
        single[run] = {}
        for prec in DP_PRECS:
            cfg = parse_config(_dp_argv(run, prec, "single")).replace(
                dp_size=0, mp_size=0)
            single[run][prec] = _dp_fold(cfg, splits, dev, None)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(DP_RUNS)) as pool:
        jobs = {run: pool.submit(_dp_launch, run) for run in DP_RUNS}
        floors = {run: _dp_noise_floor(run, "bf16",
                                       single[run]["bf16"]["probs"])
                  for run in DP_RUNS}
        ranks = {run: job.result() for run, job in jobs.items()}
    print(f"dp: every run's ranks and the noise floors done in "
          f"{time.perf_counter() - t0:.1f} s")
    failures = []
    for run, (_, _, splits, _, _) in DP_RUNS.items():
        # the ranks' checkpoints scored by the test driver in one process
        scored = {}
        for prec in DP_PRECS:
            cfg = parse_config(_dp_argv(run, prec, "single")).replace(
                dp_size=0, mp_size=0)
            paths = test_drv.checkpoints_of(
                parse_config(_dp_argv(run, prec, "ranks")))
            wire, _, table = _driver_loaders(cfg, splits)
            with _recorded_probs() as probs:
                test_drv.run_checkpoints(cfg, paths, BatchList(wire["test"]),
                                         table, dev)
            scored[prec] = np.concatenate(probs)
        failures += _dp_check(run, power, single[run], ranks[run], scored,
                              floors[run])
        gc_collect()
    print(f"dp phase ({power}): {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"data parallelism: {failures}")


def compare_row0_kernels() -> dict:
    """Phase 21 (c): the kernels that draw dropout masks at a data rank's
    row offset (row0 = the first rank's rows, the second rank's half of
    the main path's vslt rows), bf16 and fp32, at ROW0_SHAPES. dropout_masks
    bit for bit against plain_dropout_masks at row0 and against those
    rows of the whole batch's masks; the ffn forward at p 0.1 bit for bit
    against the whole batch's call on those rows, within TOL of its plain
    version, every output element its plain output mask drops exactly x;
    its backward's dx bit for bit against the whole batch's, every
    gradient within GRAD_TOL of autograd of the plain version. Each form's
    CUDA-event ms and the profiler's device ms at row0 beside row0 = 0.
    Returns {kernel: results} for the kernels line."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import \
        plain_dropout_masks
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(21)
    P, L, half = 0.1, 1024, BATCH // 2
    R, row0 = half * L, half * L
    out = {"dropout_masks": {}, "ffn": {}, "ffn_bwd": {}}
    failures = []

    def timed(call):
        ms = _median_ms(call)
        dev_ms, _ = _device_ms(call)
        return ms, dev_ms

    for C, F in ROW0_SHAPES:
        key = f"[{R},{F}]+[{R},{C}] row0 {row0}"
        call = lambda r0: ops.dropout_masks(R, F, C, DROPOUT_SEED, P, dev,
                                            row0=r0)
        got = call(row0)
        plain = plain_dropout_masks(R, F, C, DROPOUT_SEED, P, dev, row0=row0)
        whole = ops.dropout_masks(2 * R, F, C, DROPOUT_SEED, P, dev)
        same = all(torch.equal(a, b) and torch.equal(a, w[row0:])
                   for a, b, w in zip(got, plain, whole))
        ms0, dms0 = timed(lambda: call(0))
        ms1, dms1 = timed(lambda: call(row0))
        with ops.reference_path():
            plain_ms = _median_ms(lambda: call(row0), reps=3)
        bound = _bound(R * (F + C), PHILOX_OPS_PER_BYTE * R * (F + C),
                       torch.int32)
        del got, plain, whole
        print(f"kernel dropout_masks {key}: bit-identical to the plain "
              f"version and to the whole batch's rows {same}; ms {ms1:.4f} "
              f"(row0 0: {ms0:.4f}), device ms {dms1:.4f} (row0 0: "
              f"{dms0:.4f}), plain_ms {plain_ms:.3f}, bound_ms "
              f"{bound['bound_ms']:.4f} ({bound['bound_by']})")
        out["dropout_masks"][key] = {"bit_identical": same, "ms": ms1,
                                     "device_ms": dms1, "ms_row0_0": ms0,
                                     "device_ms_row0_0": dms0,
                                     "plain_ms": plain_ms, **bound,
                                     "library_ms": None}
        if not same:
            failures.append(f"dropout_masks {key}")
        if F == 0:
            continue
        lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
        lengths[BATCH - 3] = 0
        mask = length_key_mask(lengths.to(dev), L)
        for dt in (torch.bfloat16, torch.float32):
            tag = "bf16" if dt == torch.bfloat16 else "fp32"
            rnd = lambda *s, std=1.0, mean=0.0: (
                mean + std * torch.randn(*s, generator=g)).to(dev)
            ws = (rnd(C, std=.1, mean=1.), rnd(C, std=.1),
                  rnd(C, F, std=C ** -.5), rnd(F, std=.1),
                  rnd(F, C, std=F ** -.5), rnd(C, std=.1))
            x = rnd(BATCH, L, C).to(dt)
            flags = ffn_row_blocks(x, mask)
            rows_all = flags.repeat_interleave(L // flags.shape[1], dim=1)
            rows = rows_all[half:]
            xs, fs = x[half:].contiguous(), flags[half:].contiguous()
            fwd = lambda xx, ff, r0, *w: ops.ffn(
                xx, *w, ff, p=P, training=True, seed=DROPOUT_SEED, row0=r0)
            with torch.no_grad():
                y_whole = fwd(x, flags, 0, *ws)
                y = fwd(xs, fs, row0, *ws)
                with ops.reference_path():
                    y_plain = fwd(xs, fs, row0, *ws)
            live = rows.bool()
            same_f = torch.equal(y, y_whole[half:])
            err = (y.float() - y_plain.float()).abs()[live]
            atol, rtol = TOL[dt]
            bad = int((err > atol + rtol * y_plain.float().abs()[live]).sum())
            keep_z = plain_dropout_masks(R, F, C, DROPOUT_SEED, P, dev,
                                         row0=row0)[1].reshape(y.shape)
            dropped = live[:, :, None] & ~keep_z
            kept_x = bool(torch.equal(y[dropped], xs[dropped]))
            ms0, dms0 = timed(lambda: fwd(xs, fs, 0, *ws))
            ms1, dms1 = timed(lambda: fwd(xs, fs, row0, *ws))
            with ops.reference_path():
                pf_ms = _median_ms(lambda: fwd(xs, fs, row0, *ws), reps=3)
            es, n_live = xs.element_size(), float(rows.sum())
            wbytes = (2 * C * F + F + C) * 4
            bf = _bound(2 * R * C * es + wbytes, 4.0 * n_live * C * F, dt)
            bb = _bound(3 * R * C * es + 2 * wbytes, 10.0 * n_live * C * F,
                        dt)
            # backward: the half's dx against the whole batch's rows, the
            # gradients against autograd of the plain version
            # zero on the rows of dead tiles, which the kernels skip and
            # the plain version computes
            cot = rnd(BATCH, L, C).to(dt) * rows_all[:, :, None].to(dt)
            grads = {}
            for name, xx, ff, r0, cc, plain in (
                    ("whole", x, flags, 0, cot, False),
                    ("half", xs, fs, row0, cot[half:].contiguous(), False),
                    ("plain", xs, fs, row0, cot[half:].contiguous(), True)):
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (xx,) + ws]
                ctx = ops.reference_path() if plain else \
                    contextlib.nullcontext()
                with ctx:
                    yy = fwd(leaves[0], ff, r0, *leaves[1:])
                    grads[name] = torch.autograd.grad(yy, leaves, cc)
                if name == "half":
                    half_leaves, half_y = leaves, yy
            same_b = torch.equal(grads["half"][0], grads["whole"][0][half:])
            g_err = _grad_errors([t.float() for t in grads["half"]],
                                 [t.float() for t in grads["plain"]])
            bms = {}
            bc = cot[half:].contiguous()
            for r0 in (0, row0):
                yy = fwd(half_leaves[0], fs, r0, *half_leaves[1:])
                bms[r0] = timed(lambda: torch.autograd.grad(
                    yy, half_leaves, bc, retain_graph=True))
            with ops.reference_path():
                yy = fwd(half_leaves[0], fs, row0, *half_leaves[1:])
                pb_ms = _median_ms(lambda: torch.autograd.grad(
                    yy, half_leaves, bc, retain_graph=True), reps=3)
            del grads, half_leaves, half_y, yy
            print(f"kernel ffn [{R},{C}] F {F} {tag} p {P} row0 {row0}: "
                  f"forward bit-identical to the whole batch's rows "
                  f"{same_f}, {bad} outside TOL of the plain version (max "
                  f"{float(err.max()):.3e}), dropped outputs exactly x "
                  f"{kept_x}; ms {ms1:.4f} (row0 0: {ms0:.4f}), device ms "
                  f"{dms1:.4f} (row0 0: {dms0:.4f}), plain_ms {pf_ms:.3f}, "
                  f"bound_ms {bf['bound_ms']:.4f} ({bf['bound_by']}); "
                  f"backward dx bit-identical to the whole batch's rows "
                  f"{same_b}, grad |err|_F/|plain|_F "
                  f"{' '.join(f'{e:.2e}' for e in g_err)} (tol "
                  f"{GRAD_TOL[dt]:g}); ms {bms[row0][0]:.4f} (row0 0: "
                  f"{bms[0][0]:.4f}), device ms {bms[row0][1]:.4f} (row0 0: "
                  f"{bms[0][1]:.4f}), plain_ms {pb_ms:.3f}, bound_ms "
                  f"{bb['bound_ms']:.4f} ({bb['bound_by']})")
            key = f"[{R},{C}] F {F} {tag} row0 {row0}"
            out["ffn"][key] = {
                "bit_identical_to_whole": same_f, "outside_tol": bad,
                "dropped_are_x": kept_x, "ms": ms1, "device_ms": dms1,
                "ms_row0_0": ms0, "device_ms_row0_0": dms0,
                "plain_ms": pf_ms, **bf, "library_ms": None}
            out["ffn_bwd"][key] = {
                "dx_bit_identical_to_whole": same_b, "grad_err_f": max(g_err),
                "ms": bms[row0][0], "device_ms": bms[row0][1],
                "ms_row0_0": bms[0][0], "device_ms_row0_0": bms[0][1],
                "plain_ms": pb_ms, **bb, "library_ms": None}
            if not (same_f and kept_x and bad == 0 and same_b) or not all(
                    np.isfinite(e) and e <= GRAD_TOL[dt] for e in g_err):
                failures.append(f"ffn {key}")
            del x, xs, y, y_whole, y_plain, cot
            gc_collect()
    if failures:
        raise AssertionError(f"row-offset kernels: {failures}")
    return out


# phase 22: tensor parallelism for every family of the registry. Two gloo
# ranks of tpall_rank per group of TPALL_GROUPS share the card (both
# groups' launches at once) and run each run of the group in turn at
# --mp-size 2, full width, batch 64, seeded weights
# (the single process's), --dropout 0.1, adamw; meanwhile this process
# runs each on one process. The tables: each rank's launches per eval and
# per train step (derived on the CPU by counting the ops calls and the
# backwards autograd runs through their outputs, two gloo ranks, batch 2,
# the same flags). Config 4 at 6 layers: a TIE-stream attention through
# rowmm_ln and every stream's attention on the rank's 2 heads (3 a layer),
# the last layer's img and txt attentions without a backward, an FFN's
# masks a layer and stream and the input dropout's 3; the cross
# transformer: 3 self layers a stream and 3 cross layers a direction, each
# an attention (carryforward rows, no rowmm) and an FFN's masks;
# tri_mbt_vmulti: every stream's attention under its block mask (no row
# blocks, so StdLN and products), every layer's backward; tri_mt_v1: the
# joint stream's 6 (1179 rows, no row blocks), an input dropout per stream;
# tri_mbt_v2 --img-pretrain No: config 4's with every backward (the v1
# heads) and the trunk's stochastic depth (22 masks, the MLP of block 0
# fused) and backward kernels (12 + 1); unimodal_transformer --remat 1: each layer's rowmm_ln,
# attention and FFN masks again in the recompute; auxcpc_mbt: 2 streams x 6
# layers over the carryforward grid, 2 input masks
def _tp_c4(layers: int, bwd: int) -> tuple:
    ev = {"umse": 1, "attention": 3 * layers, "rowmm_ln": layers,
          "swin_attention": 12, "swin_mlp": 12}
    return ev, dict(ev, umse_bwd=1, attention_bwd=bwd, rowmm_ln_bwd=layers,
                    dropout_masks=3 * layers + 3)


_MP = ["--mp-size", "2", "--dp-size", "1"]
_C4 = _tp_c4(6, 16)
_V2 = _tp_c4(6, 18)
# C 128 and 512 at 2 of the 6 layers, for the script's 1200 s limit
# (with them at 6 the whole script took 1129.1 s on an NVIDIA H100 80GB
# HBM3 at 700 W); every kernel form of the width still launches (rowmm_ln
# and its backward at Cin 128 and 512, the attention at d_head 32 and 128)
TPALL_WIDE_LAYERS = 2
_WIDE = _tp_c4(TPALL_WIDE_LAYERS, 3 * TPALL_WIDE_LAYERS - 2)
_WIDE_ARGV = _MP + ["--transformer-num-layers", str(TPALL_WIDE_LAYERS)]
# run -> (argv, --auxiliary-loss-type or None, eval and train launches
# per step and rank)
TPALL_RUNS = {
    "c256": (CONFIG4 + _MP, None, *_C4),
    "c128": (CONFIG4 + _WIDE_ARGV + ["--transformer-dim", "128"], None,
             *_WIDE),
    "c512": (CONFIG4 + _WIDE_ARGV + ["--transformer-dim", "512"], None,
             *_WIDE),
    "cross": (CROSS + _MP, None, {"attention": 12},
              {"attention": 12, "attention_bwd": 12, "dropout_masks": 12}),
    "vmulti": (MULTI_ARGV["vmulti"] + _MP, None,
               {"umse": 1, "attention": 18, "swin_attention": 12,
                "swin_mlp": 12},
               {"umse": 1, "umse_bwd": 1, "attention": 18,
                "attention_bwd": 18, "dropout_masks": 21,
                "swin_attention": 12, "swin_mlp": 12}),
    "tri_mt": (REGISTRY_ARGV["tri_mt"] + _MP, None,
               {"umse": 1, "attention": 6, "swin_attention": 12,
                "swin_mlp": 12},
               {"umse": 1, "umse_bwd": 1, "attention": 6, "attention_bwd": 6,
                "dropout_masks": 9, "swin_attention": 12, "swin_mlp": 12}),
    "v2_no": (BASELINES["v2"] + ["--img-pretrain", "No"] + _MP, None,
              _V2[0], dict(_V2[1], swin_mlp=1,
                           dropout_masks=_V2[1]["dropout_masks"]
                           + BL_SD_MASKS, **BL_SWIN_BWD)),
    "remat": (CONFIG1 + ["--remat", "1"] + _MP, None,
              {"umse": 1, "attention": 6, "rowmm_ln": 6},
              {"umse": 1, "umse_bwd": 1, "attention": 12, "attention_bwd": 6,
               "rowmm_ln": 12, "rowmm_ln_bwd": 6, "dropout_masks": 13}),
    "auxcpc": (LEGACY_RUNS["auxcpc_mbt"][0] + _MP,
               LEGACY_RUNS["auxcpc_mbt"][1], {"attention": 12},
               {"attention": 12, "attention_bwd": 12, "dropout_masks": 14}),
}
# the runs in two launches at once (as phase 21's): each launch's runs in
# turn, the two about equal in time
TPALL_GROUPS = (("c256", "c128", "tri_mt", "auxcpc"),
                ("c512", "cross", "vmulti", "v2_no", "remat"))
TPALL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "tpall_smoke")
TPALL_SEED = 40
# train steps rank 0 times after the counted one (host clock to a
# synchronize; TP_LABEL)
TPALL_TIMED = 1


def _tpall_cfg(run: str, prec: str = "bf16", single: bool = False):
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    argv, loss = TPALL_RUNS[run][:2]
    cfg = parse_config(argv).replace(precision=prec)
    if loss:
        cfg = cfg.replace(auxiliary_loss_type=loss)
    return cfg.replace(mp_size=0, dp_size=0) if single else cfg


def _tpall_inputs(run: str):
    """The run's seeded weights (the model's own init from seed 0, the
    same in every process) and its batch."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    cfg = _tpall_cfg(run, single=True)
    state = get_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    return state, synthetic_batch(cfg, BATCH, seed=TPALL_SEED,
                                  present_frac=0.5)


def _replicated_digest(tr) -> str:
    """sha256 over the bytes of every tensor the ranks hold whole (the
    parameters and statistics tp_spec does not split), in state order."""
    import hashlib
    h = hashlib.sha256()
    for k, v in tr.model.state_dict().items():
        if k not in tr.split:
            h.update(v.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _tpall_steps(tr, batch, counted: bool):
    """An eval step, then a train step, on ``batch``: (probabilities, loss,
    the launches of each step when ``counted``)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    ops.reset_launches()
    probs = tr.eval_step(batch)[0]
    torch.cuda.synchronize()
    ev = dict(ops.launches)
    ops.reset_launches()
    loss = tr.train_step(batch)
    torch.cuda.synchronize()
    return probs, loss, ((ev, dict(ops.launches)) if counted else None)


def tpall_rank(out_dir: str, group: str) -> None:
    """One rank of phase 22 (started by parallel.launch): every run of
    TPALL_GROUPS[group] in turn from its seeded weights on its batch, at
    bf16 (the launches of an eval and a train step, then TPALL_TIMED train
    steps timed) and at fp32 (an eval and a train step, the gradients
    gathered into whole tensors); the digests of the replicated state
    after each. Writes ``out_dir``/rank{r}.pt; rank 0 also the fp32
    gradients."""
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.parallel.distributed import \
        maybe_init_distributed
    from medical_tri_modal_pilot_tpu_torch.parallel.mesh import (
        gather_state_dict, make_mesh)
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    rank, _ = maybe_init_distributed(None, "gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    for run in TPALL_GROUPS[int(group)]:
        t0 = time.perf_counter()
        state, batch = _tpall_inputs(run)
        cfg = _tpall_cfg(run)
        mesh = make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)

        def trainer(c):
            return Trainer(c, get_model(c, state=state), dev,
                           eval_only=False, seed=0, mesh=mesh)
        tr = trainer(cfg)
        probs16, loss16, counts = _tpall_steps(tr, batch, True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(TPALL_TIMED):
            tr.train_step(batch)
        torch.cuda.synchronize()
        train_ms = (time.perf_counter() - t1) * 1e3 / TPALL_TIMED
        r = {"probs16": probs16, "loss16": loss16, "eval_counts": counts[0],
             "train_counts": counts[1], "train_ms": train_ms,
             "rep16": _replicated_digest(tr), "split": len(tr.split)}
        tr.check_replicas(f"phase 22 {run}")
        del tr
        tr = trainer(cfg.replace(precision="fp32"))
        r["probs32"], r["loss32"], _ = _tpall_steps(tr, batch, False)
        names = {id(p): n for n, p in tr.model.named_parameters()}
        grads = gather_state_dict({names[id(p)]: p.grad.detach().float()
                                   for p in tr.optimizer.params}, tr.split,
                                  mesh)
        r["rep32"] = _replicated_digest(tr)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in grads.items()},
                       os.path.join(out_dir, f"{run}_grads.pt"))
        del tr, grads
        gc_collect()
        r["s"] = time.perf_counter() - t0
        res[run] = r
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _tpall_single(run: str, dev) -> dict:
    """The run in this process on the kernel path, from the same weights
    on the same batch: bf16 and fp32 eval probabilities and train-step
    losses, the fp32 step's gradients."""
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    state, batch = _tpall_inputs(run)
    out = {"state": state, "batch": batch}
    for prec in ("bf16", "fp32"):
        c = _tpall_cfg(run, prec, single=True)
        tr = Trainer(c, get_model(c, state=state), dev, eval_only=False,
                     seed=0)
        out[f"probs{prec[-2:]}"], out[f"loss{prec[-2:]}"], _ = _tpall_steps(
            tr, batch, False)
        if prec == "fp32":
            names = {id(p): n for n, p in tr.model.named_parameters()}
            out["grads"] = {names[id(p)]: (p.grad.detach().float(), None)
                            for p in tr.optimizer.params}
        del tr
        gc_collect()
    return out


def _tpall_floor(run: str, single: dict) -> float:
    """The single process's own bf16 eval distance under STEP_NOISE of
    relative weight noise: the largest over STEP_NOISE_DRAWS draws of max
    |prob diff| (phase 21's rule)."""
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    c = _tpall_cfg(run, single=True)
    floor = 0.0
    for draw in range(STEP_NOISE_DRAWS):
        g = torch.Generator().manual_seed(draw)
        model = get_model(c, state=single["state"])
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + STEP_NOISE * torch.randn(p.shape, generator=g,
                                                    dtype=p.dtype))
        tr = Trainer(c, model, torch.device("cuda"), eval_only=True)
        probs = tr.eval_step(single["batch"])[0]
        floor = max(floor, float(np.max(np.abs(probs - single["probs16"]))))
        del tr, model
    return floor


def _tpall_check(run: str, power: str, single: dict, ranks: list) -> list:
    """Phase 22's gates for ``run``: each rank's launches per eval and
    train step against the run's tables; fp32 eval probabilities within
    PROB_TOL, the step's loss within STEP_LOSS_TOL (relative past 1 for
    AUXCPC's losses, phase 20's rule) and every gathered gradient within
    STEP_FP32_TOL (Frobenius) of the single process's (phase 13); bf16
    probabilities within PROB_TOL or STEP_NOISE_RATIO of the single
    process's own distance under weight noise (phase 21's rule), the loss
    within STEP_LOSS_TOL; the ranks' replicated state equal bit for bit
    (sha256) after the bf16 steps and after the fp32 step. Returns the
    failures."""
    from medical_tri_modal_pilot_tpu_torch import ops
    _, _, eval_pp, train_pp = TPALL_RUNS[run][:4]
    r0 = ranks[0][run]
    failures = []
    bad = [(r, kind, k) for r, res in enumerate(ranks)
           for kind, pp in (("eval", eval_pp), ("train", train_pp))
           for k in ops.KERNELS
           if res[run][f"{kind}_counts"][k] != pp.get(k, 0)]
    shown = {k: v for k, v in r0["train_counts"].items() if v}
    group = next(g for g, runs in enumerate(TPALL_GROUPS) if run in runs)
    grads = torch.load(os.path.join(TPALL_DIR, f"group{group}",
                                    f"{run}_grads.pt"))
    dev = torch.device("cuda")
    tp = {k: (v.to(dev), None) for k, v in grads.items()}
    head_bn = any(k.endswith(("1.running_mean", "bn.running_mean"))
                  for k in single["state"])
    errs = _step_errors(tp, single["grads"],
                        ZERO_GRAD if head_bn else ZERO_GRAD[:1])
    rel = run == "auxcpc"
    d32 = float(np.max(np.abs(r0["probs32"] - single["probs32"])))
    d16 = float(np.max(np.abs(r0["probs16"] - single["probs16"])))
    floor = _tpall_floor(run, single) if d16 > PROB_TOL["bf16"] else None
    ok16 = d16 <= PROB_TOL["bf16"] or d16 <= STEP_NOISE_RATIO * floor
    tol = {p: STEP_LOSS_TOL[p] * (max(1.0, abs(single[f"loss{p[-2:]}"]))
                                  if rel else 1.0) for p in ("fp32", "bf16")}
    l32 = abs(r0["loss32"] - single["loss32"])
    l16 = abs(r0["loss16"] - single["loss16"])
    same = all(res[run][k] == r0[k] for res in ranks for k in ("rep16",
                                                                "rep32"))
    c = _tpall_cfg(run)
    print(f"tpall {run} (d_model {c.transformer_dim}, {c.transformer_num_head}"
          f" heads, {c.transformer_num_layers} layers): launches per rank, "
          f"train step {shown} (eval "
          f"{ {k: v for k, v in r0['eval_counts'].items() if v} }; off "
          f"{bad}); fp32 probabilities max |diff| {d32:.3e} (tol "
          f"{PROB_TOL['fp32']}), loss {r0['loss32']:.6f} vs single "
          f"{single['loss32']:.6f} (|diff| {l32:.2e}, tol "
          f"{tol['fp32']:.3g}), grads "
          f"|tp - single|_F/|single|_F over {len(errs)} tensors: "
          f"{_summary(errs)} (tol {STEP_FP32_TOL}); bf16 probabilities "
          f"{d16:.3e} (tol {PROB_TOL['bf16']}"
          + ("" if floor is None else
             f", or {STEP_NOISE_RATIO}x the single process's {floor:.3e} "
             f"under {STEP_NOISE} relative weight noise, the largest of "
             f"{STEP_NOISE_DRAWS} draws") + f"; {ok16}), loss "
          f"{r0['loss16']:.6f} vs {single['loss16']:.6f} (|diff| "
          f"{l16:.2e}, tol {tol['bf16']:.3g}); replicated state equal on "
          f"the ranks: "
          f"{same}; {r0['split']} split tensors")
    print(f"tpall {run} rank 0 ({power}; {TP_LABEL}): train "
          f"{r0['train_ms']:.1f} ms/step; the run {r0['s']:.1f} s")
    if bad:
        failures.append(f"{run}: launches {bad[:4]}")
    if not np.all(np.isfinite(r0["probs32"])) or d32 > PROB_TOL["fp32"]:
        failures.append(f"{run}: fp32 probabilities")
    if not np.isfinite(r0["loss32"]) or l32 > tol["fp32"] or \
            max(errs.values()) > STEP_FP32_TOL:
        failures.append(f"{run}: fp32 train step")
    if not np.all(np.isfinite(r0["probs16"])) or not ok16 or \
            not np.isfinite(r0["loss16"]) or l16 > tol["bf16"]:
        failures.append(f"{run}: bf16")
    if not same:
        failures.append(f"{run}: replicated state differs between ranks")
    return failures


def _tpall_launch(group: int) -> list:
    """The two ranks of tpall_rank over TPALL_GROUPS[group]; their results
    in rank order."""
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    out = os.path.join(TPALL_DIR, f"group{group}")
    os.makedirs(out)
    launch("chip_smoke:tpall_rank", 2, f"file://{out}/rendezvous",
           [out, str(group)], timeout=900)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in (0, 1)]


def start_tpall() -> tuple:
    """Phase 22's ranks: a launch of two ranks of tpall_rank per group of
    TPALL_GROUPS, both at once, each in a thread of its own. Returns (the
    clock at the start, the pool, the launches' futures)."""
    from concurrent.futures import ThreadPoolExecutor
    if sorted(sum(TPALL_GROUPS, ())) != sorted(TPALL_RUNS):
        raise AssertionError("TPALL_GROUPS must hold every run once")
    shutil.rmtree(TPALL_DIR, ignore_errors=True)
    os.makedirs(TPALL_DIR)
    pool = ThreadPoolExecutor(len(TPALL_GROUPS))
    return (time.perf_counter(), pool,
            [pool.submit(_tpall_launch, g) for g in range(len(TPALL_GROUPS))])


def run_tpall(power: str, started: Optional[tuple] = None) -> dict:
    """Phase 22: the ranks (start_tpall, or ``started``: ranks started
    earlier, beside another phase) while this process runs each run on one
    process (_tpall_single); then _tpall_check per run. Returns each
    kernel's launches per train step and rank by run."""
    t_phase, pool, jobs = started or start_tpall()
    t_here = time.perf_counter()
    dev = torch.device("cuda")
    single = {}
    for run in TPALL_RUNS:
        single[run] = _tpall_single(run, dev)
    t_single = time.perf_counter() - t_here
    groups = [job.result() for job in jobs]
    pool.shutdown()
    print(f"tpall: single process {t_single:.1f} s, the ranks done at "
          f"{time.perf_counter() - t_phase:.1f} s from their start")
    ranks = [{run: res for g in groups for run, res in g[r].items()}
             for r in (0, 1)]
    failures, counts = [], {}
    for run in TPALL_RUNS:
        failures += _tpall_check(run, power, single.pop(run), ranks)
        for k, n in ranks[0][run]["train_counts"].items():
            if n:
                counts.setdefault(k, {})[run] = n
        gc_collect()
    print(f"tpall phase ({power}): {time.perf_counter() - t_here:.1f} s "
          f"here, {time.perf_counter() - t_phase:.1f} s from the ranks' "
          "start")
    if failures:
        raise AssertionError(f"tensor parallelism of the families: "
                             f"{failures}")
    return counts


def gc_collect() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


PATH_NAMES = {"config4": "tri_mbt_vsltcls config 4 train",
              "cross": "cross_transformer_txt_vslt train",
              "tp": "tri_mbt_vsltcls config 4 train, --mp-size 2 (rank 0)",
              None: "none: no path of the JAX package dispatches it"}
PATH_STEPS = dict({k: len(v) for k, v in TRAIN_BATCHES.items()},
                  tp=len(TP_BATCHES))
# the train paths whose launches the kernels line gives under other_paths
OTHER_PATHS = dict(BASE_PATHS, vmulti2=MULTI_PATHS["vmulti2"],
                   vmultivslt=MULTI_PATHS["vmultivslt"], **REGISTRY_PATHS,
                   **BL_PATHS, **LG_PATHS)
PATH_NAMES.update(BASE_PATHS, **MULTI_PATHS, **REGISTRY_PATHS, **BL_PATHS,
                  **LG_PATHS)
PATH_STEPS.update({p: 1 for p in LG_PATHS})


# the kernels the A/B reading sums in a step and in an attn_block call:
# the last slices' (and the FMA forms they replace)
AB_KERNELS = ("umse_fwd_kernel", "umse_bwd_kernel", "col_sum_kernel",
              "dropout_masks_kernel", "ffn_kernel", "ffn_fwd_tc_kernel",
              "swin_mlp_kernel", "swin_mlp_tc_kernel", "swin_fc1_tc_kernel",
              "gemm_kernel", "gemm_bf16_kernel", "layer_norm_kernel",
              "block_qkv_tc_kernel", "block_attn_tc_kernel",
              "block_ln_bwd_tc_kernel", "rowmm_kernel", "rowmm_bwd_kernel",
              "rowmm_tc_kernel", "rowmm_bwd_tc_kernel")
AB_STEPS = 5
# attn_block forward + backward calls profiled together in ``ab``
AB_BLOCK_CALLS = 5


def _by_kernel(items, names) -> dict:
    """Profiler items (us, count, key) summed per kernel name: {name:
    [ms, launches]} for the names that launched."""
    sums = {k: [0.0, 0] for k in names}
    for t, n, key in items:
        for k in names:
            if _is_kernel(key, k):
                sums[k][0] += t / 1e3
                sums[k][1] += n
    return {k: v for k, v in sums.items() if v[1]}


def _ab_umse_masks(root: str, trainer, batch) -> dict:
    """The TIE embedding and the dropout masks as one config-4 train step
    calls them (the ops dispatchers watched over one step): the device ms
    per call of dropout_masks at each shape the step draws, at the TP FFN
    shape and at both FFN masks of the vslt stream (MASK_SHAPES), beside
    CUDA-event ms; the umse forward's device ms on the step's tensors; and
    the umse backward alone on them (the gradients of the nine parameters
    for a seeded cotangent): its device ms, its launches and its peak
    memory above what was allocated before it; then the step's peak
    memory."""
    from medical_tri_modal_pilot_tpu_torch import ops
    dev = torch.device("cuda")
    seen = {"masks": set()}
    masks_fn, umse_fn = ops.dropout_masks, ops.umse

    def record_masks(R, F, C, *args, col0=0, row0=0):
        seen["masks"].add((R, F, C, col0))
        return masks_fn(R, F, C, *args, col0=col0, row0=row0)

    def record_umse(*args):
        seen["umse"] = args
        return umse_fn(*args)

    ops.dropout_masks, ops.umse = record_masks, record_umse
    try:
        trainer.train_step(batch)
    finally:
        ops.dropout_masks, ops.umse = masks_fn, umse_fn
    out = {}
    shapes = sorted(seen["masks"]) + [MASK_SHAPES["tp_ffn"],
                                      MASK_SHAPES["ffn_whole"]]
    with torch.inference_mode():
        for R, F, C, col0 in shapes:
            call = lambda: ops.dropout_masks(R, F, C, DROPOUT_SEED, 0.1, dev,
                                             col0=col0)
            dev_ms, names = _device_ms(call)
            ms = _median_ms(call)
            key = f"dropout_masks [{R},{F}]+[{R},{C}] col0 {col0}"
            out[key] = {"device_ms": dev_ms, "ms": ms}
            print(f"ab {root}: {key}: {dev_ms:.4f} device ms, {ms:.4f} ms "
                  f"by events ({names})")
        x, *params, table, dt = seen["umse"]
        dev_ms, names = _device_ms(lambda: ops.umse(x, *params, table, dt))
        out["umse_fwd"] = {"device_ms": dev_ms, "shape": list(x.shape)}
        print(f"ab {root}: umse forward {list(x.shape)} {dt}: {dev_ms:.4f} "
              f"device ms ({names})")
    leaves = [p.detach().clone().requires_grad_(True)
              for p in params + [table]]
    y = ops.umse(x, *leaves, dt)
    dout = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)
                       ).to(dev, dt)
    backward = lambda _: torch.autograd.grad(y, leaves, dout,
                                             retain_graph=True)
    items, busy, _ = _step_split(backward, None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    backward(None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = sum(n for _, n, _ in items)
    out["umse_bwd"] = {"device_ms": busy, "launches": launches,
                       "peak_bytes": peak}
    print(f"ab {root}: umse backward alone on the step's tensors: {busy:.4f} "
          f"device ms in {launches} launches, peak {peak / 2 ** 20:.1f} MiB "
          f"above its inputs; top: " + ", ".join(
              f"{key[:40]} x{n} {t / 1e3:.4f}" for t, n, key in items[:6]))
    del y, leaves, dout
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    out["step_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"ab {root}: config4 bf16 train step peak device memory "
          f"{out['step_peak_bytes'] / 2 ** 30:.3f} GiB")
    return out


def ab(root: str, power: str) -> None:
    """The A/B reading for the package under ``root`` (a git archive of one
    tree), all bf16, profiler device ms: per call, the ffn forward at the
    vslt shape ([64, 1024, 256], TIE-length tile flags; dropout 0 and 0.1),
    swin_mlp at Swin-T's four stages over the main path's 33 trunk rows,
    and the four rowmm forms at the rowmm phase's shapes (forward and
    backward, LN-fused at W [256, 384] and plain at [256, 768]); per
    launch, the attn_block kernels of AB_BLOCK_CALLS training forwards and
    backwards at [64, 1024, 256] (TIE key mask); the dropout masks and the
    umse forward and backward as a config-4 train step calls them
    (_ab_umse_masks); then one config-4 train step's device busy time, host
    wall, and the device ms of each of AB_KERNELS in it; the device busy
    time, host wall and tile-map launches of one tri_mbt_vmulti step and
    one config-4 step at d_model 512 / 4 heads; and the host-clock ms/step
    of config 4, the cross transformer, tri_mbt_vmulti and config 4 at
    512 / 4 over AB_STEPS unprofiled train steps. Only the
    wrappers both trees have are called. One process per tree, in turns
    (parent, change, change, parent), each building its kernels into
    <root>/build:

        python3 chip_smoke.py ab build/parent
    """
    sys.path.insert(0, os.path.abspath(root))
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import BLOCK_R
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    if not ops.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"ab: imported {ops.__file__}, not {root}")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    out = {"root": root, "device": power}
    D, F, L = 256, 1024, 1024
    lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
    mask = length_key_mask(lengths.to(dev), L)
    x = rnd(BATCH, L, D).to(bf16)
    flags = ffn_row_blocks(x, mask)
    ws = (rnd(D, std=.1, mean=1.), rnd(D, std=.1),
          rnd(D, F, std=D ** -.5).to(bf16), rnd(F, std=.1).to(bf16),
          rnd(F, D, std=F ** -.5).to(bf16), rnd(D, std=.1).to(bf16))
    with torch.inference_mode():
        for p in (0.0, 0.1):
            ms, names = _device_ms(lambda: ops.ffn(
                x, *ws, flags, p=p, training=True, seed=DROPOUT_SEED))
            out[f"ffn_p{p}"] = ms
            print(f"ab {root}: ffn [65536,256] p {p}: {ms:.4f} device ms "
                  f"per call ({names})")
        for side, C, _, _ in SWIN_STAGES:
            R = TRUNK_ROWS[0] * side * side
            xm = rnd(R, C).to(bf16)
            mw = (rnd(C, std=.1, mean=1.), rnd(C, std=.1),
                  rnd(C, 4 * C, std=C ** -.5).to(bf16), rnd(4 * C, std=.1),
                  rnd(4 * C, C, std=(4 * C) ** -.5).to(bf16),
                  rnd(C, std=.1))
            ms, names = _device_ms(lambda: ops.swin_mlp(xm, *mw))
            out[f"swin_mlp_{C}"] = ms
            print(f"ab {root}: swin_mlp [{R},{C}]: {ms:.4f} device ms per "
                  f"call ({names})")
    # the rowmm forms at the rowmm phase's block flags
    rflags = ffn_row_blocks(x, mask, BLOCK_R)
    rlive = rflags.repeat_interleave(BLOCK_R, dim=1)
    for key, cout, ln in (ROWMM_SHAPES[0], ROWMM_SHAPES[2]):
        inputs, fwd, cot = _rowmm_case(g, dev, bf16, cout, ln, rlive, rflags)
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        f_ms, names = _device_ms(lambda: fwd(*leaves))
        y = fwd(*leaves)
        b_ms, more = _device_ms(lambda: torch.autograd.grad(
            y, leaves, cot, retain_graph=True))
        out[key], out[f"{key}_bwd"] = f_ms, b_ms
        print(f"ab {root}: {key} [65536,256]x[256,{cout}]: forward "
              f"{f_ms:.4f}, backward {b_ms:.4f} device ms per call "
              f"({sorted(set(names + more))})")
        del leaves, y, inputs, cot
    # the attention block's projection kernels, per launch
    blk = [rnd(D, std=.1, mean=1.), rnd(D, std=.1),
           rnd(D, 3 * D, std=D ** -.5).to(bf16), rnd(3 * D, std=.1).to(bf16)]
    leaves = [t.detach().clone().requires_grad_(True) for t in [x] + blk]
    bcot = rnd(BATCH, L, D).to(bf16)

    def block_calls(_):
        for _ in range(AB_BLOCK_CALLS):
            y = ops.attn_block(*leaves, mask, 8.0, 4)
            torch.autograd.grad(y, leaves, bcot)
    items, busy, _ = _step_split(block_calls, None)
    split = _by_kernel(items, AB_KERNELS)
    out["attn_block_kernels"] = split
    print(f"ab {root}: attn_block [64,1024,256] training forward + "
          f"backward: {busy / AB_BLOCK_CALLS:.4f} device ms per call; " +
          ", ".join(f"{k} x{n} {t / n:.4f} ms a launch"
                    for k, (t, n) in split.items()))
    del leaves, bcot
    cfg = parse_config(CONFIG4)
    model = get_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, dev, eval_only=False, seed=0)
    batch = synthetic_batch(cfg, BATCH, seed=10,
                            present_frac=TRAIN_BATCHES["config4"][0])
    out.update(_ab_umse_masks(root, trainer, batch))
    items, busy, wall = _step_split(trainer.train_step, batch)
    sums = _by_kernel(items, AB_KERNELS)
    # the kernels alone: the pageable H2D copy moves by milliseconds
    # between steps
    kernels = sum(t for t, _, key in items if not key.startswith("Memcpy"))
    out.update(step_busy_ms=busy, step_kernels_ms=kernels / 1e3,
               step_wall_ms=wall, step_kernels=sums)
    print(f"ab {root}: config4 bf16 train step: device busy {busy:.2f} ms "
          f"({kernels / 1e3:.2f} ms in kernels, copies left out) of "
          f"{wall:.2f} ms host wall; " + ", ".join(
              f"{k} x{n} {t:.3f} ms" for k, (t, n) in sums.items()))
    d512 = CONFIG4 + ["--transformer-dim", "512", "--transformer-num-head",
                      "4"]
    for name, argv, frac in (
            ("config4", CONFIG4, None),
            ("cross", CROSS, TRAIN_BATCHES["cross"][0]),
            ("vmulti", MULTI_ARGV["vmulti"], TRAIN_BATCHES["vmulti"][0]),
            ("config4_d512", d512, WIDTH_BATCHES[0])):
        if name != "config4":
            del trainer, model
            gc_collect()
            cfg = parse_config(argv)
            model = get_model(cfg, torch.Generator().manual_seed(0))
            trainer = Trainer(cfg, model, dev, eval_only=False, seed=0)
            batch = synthetic_batch(cfg, BATCH, seed=10, present_frac=frac)
            trainer.train_step(batch)
        if name in ("vmulti", "config4_d512"):
            items, busy, wall = _step_split(trainer.train_step, batch)
            maps = _by_kernel(items, ("block_tile_map_kernel",)).get(
                "block_tile_map_kernel", [0.0, 0])
            out[f"{name}_step"] = {"busy_ms": busy, "wall_ms": wall,
                                   "tile_maps": maps[1],
                                   "tile_map_ms": maps[0]}
            print(f"ab {root}: {name} bf16 train step: device busy "
                  f"{busy:.2f} ms of {wall:.2f} ms host wall, idle share "
                  f"{max(0.0, 1 - busy / wall):.3f}; block_tile_map_kernel "
                  f"x{maps[1]} {maps[0]:.4f} ms; top: " + ", ".join(
                      f"{key[:40]} x{n} {t / 1e3:.3f}"
                      for t, n, key in items[:8]))
        ms = _timed_train_ms(trainer, [batch] * AB_STEPS, reference=False)
        out[f"{name}_step_ms"] = ms
        print(f"ab {root}: {name} bf16 train step {ms:.2f} ms (host clock, "
              f"{AB_STEPS} steps)")
    print("ab " + json.dumps(out))


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "ab":
        ab(sys.argv[2], check_device())
        return
    if len(sys.argv) in (2, 3) and sys.argv[1] == "stepgate":
        power = check_device()
        stepgate(sys.argv[2] if len(sys.argv) == 3 else ".", power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "saver":
        power = check_device()
        build_kernels()
        saver_ab(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "baseline":
        power = check_device()
        build_kernels()
        run_baseline(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "multitoken":
        power = check_device()
        build_kernels()
        run_multitoken(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "registry":
        power = check_device()
        build_kernels()
        run_registry(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "baselines":
        power = check_device()
        build_kernels()
        run_baselines(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "widths":
        power = check_device()
        build_kernels()
        compare_width_kernels()
        run_widths(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "gradprobe":
        power = check_device()
        build_kernels()
        gradprobe(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "keyprobe":
        power = check_device()
        build_kernels()
        keyprobe(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "trunkprobe":
        power = check_device()
        build_kernels()
        trunkprobe(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "legacyprobe":
        power = check_device()
        build_kernels()
        legacyprobe(power)
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "legacy":
        power = check_device()
        build_kernels()
        run_legacy(power, sys.argv[2:])
        return
    if len(sys.argv) == 2 and sys.argv[1] == "dp":
        power = check_device()
        build_kernels()
        compare_row0_kernels()
        run_dp(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "tpall":
        power = check_device()
        build_kernels()
        run_tpall(power)
        return
    if len(sys.argv) == 2 and sys.argv[1] == "tpdrivers":
        power = check_device()
        build_kernels()
        run_tp_drivers(power)
        return
    t_start = time.perf_counter()

    def clock(what):
        print(f"clock: {what} done at {time.perf_counter() - t_start:.1f} s")
    power = check_device()
    build_kernels()
    results = compare_kernels()
    results.update(compare_umse_bwd())
    results.update(compare_dropout_masks())
    results.update(compare_training_kernels())
    results.update(compare_attention_kernels())
    results.update(compare_rowmm_kernels())
    widths = compare_width_kernels()
    clock("build and kernels (1-3, 5b, 6, 9, 12, 3w)")
    run_config("vslt_txt", VSLT_TXT, power, timed=True)
    run_config("config4", CONFIG4, power, timed=True)
    run_config("config5", CONFIG5, power, timed=False)
    counts = {"config4": run_train("config4", CONFIG4, power, timed=True)}
    run_train("vslt_txt", VSLT_TXT, power, timed=False)
    run_config("cross", CROSS, power, timed=True)
    counts["cross"] = run_train("cross", CROSS, power, timed=True)
    clock("configs and the cross transformer (4-8, 10-11)")
    counts["tp"] = run_tp(power)
    run_drivers(power)
    run_tp_drivers(power)
    clock("TP and the drivers (13, 14, 14b)")
    counts.update(run_baseline(power))
    clock("phase 15")
    mt_results, mt_counts = run_multitoken(power)
    results.update(mt_results)
    counts.update(mt_counts)
    clock("phase 16")
    run_widths(power)
    clock("phase 17")
    joint, reg_counts = run_registry(power)
    counts.update(reg_counts)
    clock("phase 18")
    bl_results, bl_counts = run_baselines(power)
    counts.update(bl_counts)
    # the trunk's backward kernels, measured in phase 19
    for name in ("swin_attention_bwd", "swin_mlp_bwd"):
        results[name] = bl_results.pop(name)
    clock("phase 19")
    lg_results, lg_counts = run_legacy(power)
    counts.update(lg_counts)
    clock("phase 20")
    row0 = compare_row0_kernels()
    # phase 22's ranks run beside phase 21 (neither gives a speed figure:
    # every rank shares the card over gloo)
    started = start_tpall()
    run_dp(power)
    clock("phase 21 (phase 22's ranks beside it)")
    tpall = run_tpall(power, started)
    clock("phase 22")
    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        path = KERNEL_PATHS[name]
        # the launches of phases 15, 16 and 18's other train paths, each
        # over its steps
        also = {PATH_NAMES[p]: {"launches": counts[p][name],
                                "steps": PATH_STEPS[p]}
                for p in OTHER_PATHS if counts[p][name]}
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "path": PATH_NAMES[path],
                        "launches": counts[path][name] if path else 0,
                        "steps": PATH_STEPS[path] if path else 0,
                        "other_paths": also, **results[name],
                        "widths": widths.get(name, {}),
                        "mt_joint": joint.get(name, {}),
                        "baselines": bl_results.get(name, {}),
                        "legacy": lg_results.get(name, {}),
                        "row0": row0.get(name, {}),
                        "tpall": tpall.get(name, {}),
                        "tp_shapes": {
                            k: results[f"{name}_{k}"] for k in (
                                "tp_cross", "tp_cross_train", "tp_block",
                                "tp_block_train")
                            if f"{name}_{k}" in results}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
