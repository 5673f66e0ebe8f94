"""Chip smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # everything below, on one card
    python3 chip_smoke.py --probe-batch N  # only: does a train step fit at batch N?
    python3 chip_smoke.py --compare-sums-source OLD/channel_sums.cu
        # only: the sums kernels against those built from an older
        # channel_sums.cu, on the grid of that commit's ops/channel_sums.py
        # (copied to OLD/channel_sums.py), in turns, at the BatchNorm shapes of
        # the resnet34 step, the mobilenet_v2 U-Net, DeepLabV3Plus, resnet50
        # and the discriminators
    python3 chip_smoke.py --compare-dihedral-source OLD.cu
        # only: dihedral_normalize against the one built from an older
        # dihedral_normalize.cu, at the train step's shape, in turns
    python3 chip_smoke.py --only-scan      # only: 3c and phases 15-16
    python3 chip_smoke.py --only-dist      # only: phase 17
    python3 chip_smoke.py --only-spatial   # only: phases 18 and 18b

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the port's four CUDA libraries from ``csrc/`` with nvcc, all
   compilers started together;
3. holds every kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with the tolerance beside it, and
   times kernel, plain version, the one PyTorch call that computes the same
   function (where there is one) and the roofline bound:
   - ``conv_bn_relu`` at the serving shapes (B=32: 256x256x32->32 and
     512x512x16->16, bf16 and f32, with and without the BN affine, with
     moments, two launches bit-identical) and at the edges of the bf16
     tensor-core tiling (Cin 3 and 24, Cout 8 and 20, H and W off the tile
     grid, B=1 at both serving shapes); kernel, plain version and library
     call are timed as 20 launches between two CUDA events, so the host's
     launch overhead is not counted (the single-launch time stands beside);
   - ``channel_sums`` / ``channel_dual_sums`` at every BatchNorm input of
     the train step (B=32, 7 shapes from 16x16x512 to 512x512x16), bf16,
     three of them in f32, timed as 20 launches per event pair over rotating
     input copies larger than twice the L2 and as the profiler's kernel
     duration; untimed at the edges (C=3, 16, 24, 512, M=1, ragged rows,
     rows of 3, 120 and 160 vectors, bf16 C=20 and f32 C=1280 on the
     generic path, mixed bf16/f32 duals, an unaligned view); one device
     kernel per call (at rows of 3 and 120 vectors too),
     1,000 calls in a row and two streams at once give the same bits; the
     wrapper's host time per call;
   - ``dihedral_normalize`` at (32, 512, 512, 3) uint8 with uint8 masks, for
     a batch of all eight group elements, one of identity and flips only and
     one of transposes only, ``normalize`` both ways, bit-exact, two launches
     bit-identical, one device kernel a call; bit-exact at the edges (generic
     path, partial units, unaligned view, int64 flags with high bits, wide
     masks); timed per batch as 20 launches per event pair on rotating cold
     copies and as the profiler's kernel duration, the single-launch time and
     the wrapper's host time beside; then ``augment_batch`` at the step's
     shape for the dihedral-only pipeline, ``WEAK`` and ``STRONG`` (draws
     from a generator on the card), one line each: ms as 20 calls per event
     pair on cold copies, device ms and launches by kind and by stage
     (draws, dihedral kernel + cast, warps, noise, blur, colour, HSV,
     normalize), the peak memory a call adds, and one call under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
   - the sums kernels also at the discriminator's three BatchNorm inputs
     of phases 2 and 3 ((32·128², 128), (32·64², 256), (32·32², 512), bf16,
     forward and dual, timed as above), at phase 11's BatchNorm inputs that
     the resnet34 step lacks (the resnet50 U-Net's seven, C from 128 to 2048,
     and the feature discriminator's (32·16², 256) and (32·16², 128); timed
     as above; float32 at C=1024 and 2048 untimed), and ``dihedral_normalize`` without
     masks (the target batches of phases 2 and 3) at (32, 512, 512, 3) for
     each batch class, bit-exact, timed for the mixed class;
   - ``fused_cross_entropy`` at (32, 512, 512, 23) f32 and bf16, forward
     and backward;
4. drives the serving path -- resnet34 U-Net, 23 classes, 512 px tiles,
   bf16, seeded random weights -- through ``predict_batch`` (B=32) and
   ``predict_raster`` (2000x1500 raster), checks that every forward
   launched ``conv_bn_relu`` exactly twice, times the forward (CUDA events)
   and breaks its device time down by kernel (``torch.profiler``), and
   checks the fused path against the plain one in f32;
5. drives the train path at the same width -- ``make_supervised_train_step``
   with its default augmentation (``WEAK``, every stage, as in the JAX
   package), ``fused_ce=True`` and ``adam(1e-4)``, B=32 uint8 tiles and
   masks, 5 steps from seeded weights and batches --
   and checks finite losses, changed parameters and BatchNorm buffers,
   ``hist.sum()``, and the exact launch counts per step (one
   ``channel_sums`` and one ``channel_dual_sums`` per BatchNorm, one
   ``dihedral_normalize``, two ``fused_cross_entropy``); times the step,
   reads the peak memory and breaks the device time down by kind, with
   launches per kind; counts the incoming BatchNorm gradients that
   ``bn_train`` has to copy before the dual sums; then times the same step
   with the dihedral-only augmentation on its own line;
6. runs ``make_eval_step`` on the trained model (2 ``conv_bn_relu``
   launches, finite loss);
7. holds every augmentation stage of WEAK and STRONG (float32, every gate
   on) on the card against the CPU, stage by stage, and one float32 train
   step on the card (kernels) against the same step on a CPU copy of the
   model (plain versions), WEAK in float32 with the same seeded draws
   (made once on the host);
8. prints one JSON line of kernel results (launches summed over the main
   paths of 4, 5, 6 and 9-18b), the card line again, and last
   ``{"ok": true, "device": {...}}``.
9. (after 7, before 8 prints; in a spawned process of its own, whose
   launch counts 8 adds in) drives the phase-1 trainer,
   ``SegmentationTrainer.train``, for 2 epochs on the same model width with
   the trainer's own step (``WEAK``, plain CE, ``adam(1e-4)``): an in-memory dataset of 80 seeded 512 px
   tiles with the ``load_raw`` contract, ``random_split`` 64 / 16, a
   ``WeightedRandomSampler`` from ``class_balance``, ``DataLoader``s at
   B=32 (2 worker threads), logs and checkpoints in a temporary directory,
   the early stopper's ``min_epochs`` lowered to 1 so that the run saves a
   best model.  Checks, per train step, 46 ``channel_sums``, 46
   ``channel_dual_sums``, 1 ``dihedral_normalize`` and 0 other launches
   (and none outside the steps); uint8 images and masks on the card; in the
   last epoch's profile, H2D copies of exactly the batches' bytes, pinned,
   on a stream other than the compute stream; the best checkpoint reloaded
   through ``from_jax_state_dict`` gives bit-identical logits; the event
   file's CRCs and the JAX trainer's tags.  Prints a ``trainer`` line:
   ``StepTimer`` p50 / p95 and tiles/s, the bare step time, H2D ms per
   batch and its overlapped share, the device busy share of the last epoch,
   validation ms, the host ms of each figure-logging batch, checkpoint bytes
   and write ms, host syncs per train step, peak memory, and which of
   cv2 / PIL / pandas / tqdm / matplotlib / seaborn / sklearn / tensorboard
   / g++ / libjpeg / libpng the machine has.
10. (after 9, in a spawned process of its own) drives the three-phase
   pipeline, ``run_pipeline(phase1_epochs=1, phase2_epochs=1,
   phase3_epochs=1, batch_size=32, force_transitions=True)``, on the same
   model width with the JAX defaults (phase 2: ``WEAK``, ``lambda_adv``
   0.001, per-domain discriminator forwards; phase 3: ``STRONG`` views,
   ``adam(lr * 0.1, clip_norm=1.0)`` over both models, and what
   ``UnsupervisedTrainer`` resolves to on the card: the sequential step over
   an encoder-remat, bf16-logits clone of the U-Net with a bf16 carry), its
   ``_build_loaders`` replaced in that process by in-memory loaders (the
   80 source tiles split 64 / 16, 64 seeded target tiles with another
   photometric offset, shuffled, ``drop_last``): 2 steps a phase.  Checks
   the launches of every step (phase 1: 46 / 46 / 1 / 0; phase 2: 52 / 52
   / 2 / 0, the U-Net and the discriminator on both domains; phase 3: 211 /
   95 / 2 / 0, the discriminator once, the U-Net on view 1 without
   gradients and on views 2 and 1 with them, the 35 BatchNorms of the
   encoder's blocks recomputed in both backward passes) and none
   outside the steps; the summary's three phases and
   ``training_metadata.json``; every phase's best checkpoint reloaded
   through ``from_jax_state_dict`` (U-Net, and the discriminator of phases
   2 and 3) gives bit-identical logits; the discriminator's BatchNorm input
   shapes; one phase-3 step with a NaN in the discriminator's classifier
   bias leaves every element of the state bit-identical and reports
   ``finite`` false.  Prints a ``pipeline`` line: per phase the bare step
   (p50 of 5 after a warm-up, CUDA events, batches on the card), tiles/s,
   launches per step, peak memory, host syncs per step, device ms by kind
   (profiler); phase 3's consistency KL alone (forward + backward, chunked
   and whole, with its byte bound); checkpoint MB and write ms per phase;
   the pipeline's wall time.
11. (after 10, in a spawned process of its own) drives the GRL stack's
   ``MultiPhaseTrainer`` over ``create_uda_model``'s default model -- a
   resnet50 U-Net (23 classes, 512 px, bf16, seeded random weights) whose
   bottleneck feeds the feature discriminator (512 / 256 / 128 channels)
   through the gradient-reversal layer -- at B=32, one epoch a phase over
   the in-memory tiles of phase 10 (2 steps a phase): ``phase1_train``
   (dice), ``phase2_train`` (the sequential GRL step, ``lambda_domain``
   0.001, WEAK; target train batches stand in for target validation),
   ``phase3_train`` (two STRONG views, MSE + 0.1 * confusion); checkpoints in
   a temporary directory.  Checks the BatchNorm input shapes of a traversal
   against the census, the launches of every step (phase 1: 63 / 63 / 1 / 0;
   phase 2: 122 / 122 / 2 / 0, the source traversal 66 and the
   ``domain_only`` target traversal 56; phase 3: 192 / 182 / 2 / 0, ``x0``'s
   decoder getting no gradient) and none outside the steps, and the three
   ``phase{n}_best.pth`` reloaded through ``from_jax_state_dict`` to
   bit-identical segmentation and domain logits.  Prints a ``multiphase``
   line: per phase the bare step (p50 of 5 after a warm-up, CUDA events,
   batches on the card), tiles/s, peak memory, host syncs per step, device
   ms by kind (profiler) and the phase's wall time; checkpoint MB and write
   ms; the trainer's wall time and phase 11's with its process.
12. (after 11, in a spawned process of its own) runs the port's system test
   CLI, ``test_system.test_system()``, with all 14 suites at the Config
   defaults (resnet34 U-Net, 23 classes, 256 px, B=8, bf16, the default
   ``ENCODER_WEIGHTS="imagenet"`` without a converted file: a warning, the
   seeded weights) in a temporary working directory, over the fixtures that
   the port's ``setup_test_data`` writes there with cv2.  Requires ``True``
   and 14 ✓.  Counts the five kernels' launches per suite and per train step:
   every step of the three trainers exactly as in phase 10 (46 / 46 / 1 / 0,
   52 / 52 / 2 / 0, 211 / 95 / 2 / 0; phase 3 at B=1), and outside the steps
   only one ``dihedral_normalize`` per item augmentation (a dataset's
   transform), no ``conv_bn_relu`` and no ``fused_cross_entropy``.  Then:
   the ``model_io`` file (JAX layout) reloaded through
   ``from_jax_state_dict`` gives bit-identical logits; ``log_model_graph``
   wrote ``model/structure`` and ``model/graph``; ``predict_mask`` on the
   card equals a CPU copy of the model in float32 outside the band
   |p - 0.5| < 1e-4 (the count in the band is printed); the sums kernels
   against their plain versions at every train-mode BatchNorm input of the
   run (untimed, phase 3's tolerance) and ``dihedral_normalize`` bit-exact
   at (8 / 2 / 1, 256, 256, 3) with no, uint8 and int32 masks.  Prints a
   ``system`` line: per suite ✓, wall s, launches, steps and item
   augmentations; the run's launches, peak memory, ``test_system``'s wall
   time and phase 12's with its process.
13. (after 12, in a spawned process of its own) the memory-decomposed
   phases 2 and 3 and the phase-3 production point of ``bench.py --mode
   unsup``: the resnet34 U-Net (23 classes, 512 px, bf16, seeded weights)
   with ``remat="encoder"``, ``logits_dtype=torch.bfloat16`` under
   ``make_unsupervised_sequential_step(carry_dtype=torch.bfloat16)`` and
   ``FineTuningLoss()``.  At B=32, on the same draws from the same state,
   one update of each: the joint phase-3 step twice (the card's own
   reproducibility), the sequential phase-3 step (no remat, no carry cast)
   against the joint one, the sequential step with encoder remat against
   it without; each held to its reference by the loss scalars (1e-6
   relative), every BatchNorm buffer bit-identical, the clipped gradients
   (1e-6 of each tensor's largest for the repeat and for remat, 1e-5 for
   sequential against joint) and the parameters by the Adam-sign rule
   (``hold_update``), with the exact launches of each step (95 / 95 / 2 /
   0 joint, 141 / 95 / 2 / 0 sequential, 211 / 95 / 2 / 0 under encoder
   remat, 52 / 52 / 2 / 0 for the phase-2 step, which the port runs under
   both JAX names).  Then for the two phase-3 steps, the production point
   and the phase-2 step: the bare step (p50 of 5 after a
   warm-up, CUDA events, batches on the card), tiles/s, the peak memory
   from a reset, launches per step and one step under
   ``set_sync_debug_mode("error")``; both sequential phase-3 steps must peak
   below the joint one.  The batch ladder 128, 64, 32 of the production
   point (an out-of-memory is a row, not an error): the largest batch that
   fits, its bare step, tiles/s and peak.  ``UnsupervisedTrainer`` with its
   defaults resolves to encoder remat, the sequential step and a bf16 carry
   and trains one epoch of 2 steps over 64 in-memory target tiles (211 / 95
   / 2 / 0 a step, none outside); the model keeps its own remat and float32
   logits.  Last, the sums kernels against their plain versions at every
   BatchNorm input whose statistics were frozen (the recompute and
   ``grad_view1``), untimed, at phase 3's tolerance.  Prints a
   ``production`` line.
14. (after 13, in a spawned process of its own) the other families of
   ``create_model`` -- FPN, PSPNet, Linknet, UnetPlusPlus, DeepLabV3Plus,
   PAN, MAnet at resnet34 -- and the U-Net at mobilenet_v2
   (``fused_eval=True``), each as ``create_model`` builds it (23 classes,
   512 px, bf16, seeded weights).  First the models' resize on the card:
   every route keeps channels_last, and whether the antialiased bilinear
   runs in bf16 with a backward there.  Per model: ``predict_batch`` at B=32
   (2 ``conv_bn_relu`` launches for the mobilenet U-Net, none for the
   families), the forward alone (CUDA events) and its peak; then, at B=32,
   the census of BatchNorm inputs on a copy's first step (every input channels_last), 3 steps of
   ``make_supervised_train_step`` (``WEAK``, plain CE, ``adam(1e-4)``) with
   exactly one ``channel_sums`` and one ``channel_dual_sums`` per BatchNorm
   (40, 41, 51, 56, 45, 49, 45, 62), one ``dihedral_normalize`` and nothing
   else a step, finite losses, every buffer moved and every parameter moved
   or without a gradient, the bare step (``measure_step``: p50 of 5, peak,
   one step under ``set_sync_debug_mode("error")``), device ms by kind for
   PSPNet, DeepLabV3Plus and the mobilenet U-Net; one float32 step (B=4, 128 px,
   WEAK with host draws) on the card against a CPU copy, phase 7's
   tolerances.  Then ``train_model`` with ``Config.MODEL_NAME =
   "DeepLabV3Plus"`` for 1 epoch (2 steps) over phase 9's kind of
   in-memory tiles, its launches, and its ``final_model.pth`` reloaded
   through ``from_jax_state_dict`` to bit-identical logits.  Last the sums
   kernels against their plain versions at every BatchNorm input shape no
   earlier phase has (each with its path and its vectors a row, timed as in
   3 with ``torch.var_mean`` as the library call), the mobilenet U-Net's
   and DeepLabV3Plus's census of rows that hold no power of two of vectors
   checked against ``MOBILENET_UNET_WIDENED`` / ``DEEPLAB_WIDENED``, every
   one on the bulk path, and the mobilenet U-Net's 42 such inputs a step
   (kernel ms, bound, library).  Prints an ``architectures`` line.
15. (after 14, in a spawned process of its own, with 16) ``make_scan_driver``:
   the train steps as CUDA graphs at full width (512 px, bf16, B=32, WEAK /
   STRONG, capturable states): the resnet34 U-Net's phase-1 step with
   plain and with fused CE (S=4, unroll 1 and 4), the phase-2 step (S=2),
   the phase-3 production point (S=2: the sequential step, encoder remat,
   bf16 logits and carry, an ``(S,)`` epoch) and the GRL sequential step at
   resnet50 (S=2, an ``(S,)`` alpha).  Per case: two eager runs of the S
   steps from the same state and generator seed, then the scan driver's first
   call (warm-up, capture, replays); every metric, parameter, buffer, Adam
   tensor and step counter of the scan driver bit-identical to the eager run's
   where the two eager runs are bit-identical, elsewhere within their gap
   (printed); the device census of one replayed call (profiler: sums
   kernels by their DUAL flag, the dihedral kernel, ``ce_fwd`` / ``ce_bwd``)
   equal to the eager step's (46 / 46 / 1 / 0, with fused CE 46 / 46 / 1 / 2,
   52 / 52 / 2 / 0, 211 / 95 / 2 / 0, 122 / 122 / 2 / 0), itself checked
   against the eager step's profile; one call under
   ``set_sync_debug_mode("error")``.  A ``phase 15`` line per case: eager
   p50 step ms, graph ms per step (CUDA events over a call of replays),
   host µs per call, busy share, warm-up and capture ms, the first call's
   peak and the graph pool's size.
16. ``Unet(fused_decoder=...)``: ``False``, ``True`` and ``"dilated"`` at
   resnet34, 23 classes, bf16, the same weights, timed in turns (naive,
   ``True``, ``"dilated"``, then back): the phase-1 bare step (WEAK, fused
   CE, B=32, ``measure_step``: ms, peak above what is resident, launches 46
   / 46 / 1 / 2, no host sync), the same step as ``make_scan_driver``'s
   CUDA graph replays (S=2: its device time) and the serving forward at
   B=32 with ``fused_eval`` off and on (ms, peak, 0 / 2 ``conv_bn_relu``
   launches); each fused
   schedule in float32 on the card against the naive one (B=4: eval and
   train-mode logits 2e-4, the CE 1e-5 relative, its gradients 3e-2
   relative L2 and the head's 1e-4, the CPU test's tolerances).
3c (in the main process, after 3b) each kernel alone in a CUDA graph at
   its main-path shapes (``conv_bn_relu`` at the two serving shapes, the
   sums and dual at the step's seven BatchNorm inputs and at (32·16², 960),
   120 vectors a row, ``dihedral_normalize``
   with and without masks, ``fused_cross_entropy`` forward and backward in
   bf16), captured on a side stream after one launch there, replayed three
   times, bit for bit against the eager launch: a ``capture_check`` line
   and each ``kernels`` entry's ``capture_check``.
17. (after 15-16, in a spawned process of its own, which spawns the ranks of
   17b) data parallelism across processes (``parallel.distributed``).
   17a: the resnet34 U-Net's phase-1 step (23 classes, 512 px, bf16, B=32,
   WEAK, fused CE), 3 steps through the data-parallel path under an NCCL
   group of one process against the same 3 steps without a group: every
   parameter, gradient, BatchNorm buffer and metric bit for bit, launches
   46 / 46 / 1 / 2 a step; the collectives a step by kind and bytes; the
   step's p50 with and without the group, and a ``torch.profiler`` trace
   (CPU activity) of one step of each, with the all-reduce ops' host time;
   ``make_scan_driver`` at S=2 over the
   grouped step (the collectives captured with it), bit for bit against two
   eager runs where those are.  Then, outside the counted run,
   ``augment_batch`` with phase 3's STRONG config as a rank runs it (the
   global batch's draws on its rows, no compaction) against the compacted
   stages at the same row count, for 2 and 4 ranks of a global 32 and 128.
   17b: two ranks sharing the card through
   gloo (``local_device_ids=[0]``), each with its 16 rows of a global B=32:
   the phase-1 step in float32 with TF32 off against one process at B=32
   with the same global draws, in two forms: the plain step, and a witness
   that repeats the ranks' arithmetic (the BatchNorm sums of the two halves
   added, as the all-reduce adds the ranks', and every convolution run on
   each half, its weight gradient the sum of the halves') -- loss 1e-5
   relative, BatchNorm buffers 1e-5, clipped gradients 1e-4 of each
   tensor's largest against the witness and 1e-2 against the plain step,
   parameters by the Adam-sign rule; a line of gradient gaps, with the split
   sums alone and cuDNN's deterministic algorithms beside, comes before the
   checks -- and in bf16 (finite, loss 1e-2 relative); one step each
   of phase 2 and of phase 3's production point (sequential, encoder remat,
   bf16 carry: the collectives inside the recompute), finite, BatchNorm
   buffers identical across the ranks; the per-rank census of every step;
   ``run_pipeline`` over the two ranks at the CLI defaults (256 px, B=8 a
   rank, in-memory tiles through ``pipeline._build_loaders``' even shards),
   one epoch a phase of 2 steps: both ranks end in FINE_TUNING with the same
   weights bit for bit and the same summary, and only rank 0 wrote
   checkpoints, metadata and events.  A rank that fails or does not finish
   in time fails the run.  The two-rank times are printed as correctness
   runs: two ranks share one card and gloo stages through the host.
18. (after 17, in a spawned process of its own, which spawns four ranks)
   the height-sharded eval forward (``parallel.spatial.spatial_forward``)
   over four gloo ranks sharing the card (``local_device_ids=[0]``; NCCL
   refuses two ranks on one card).  The resnet34 U-Net at 23 classes with
   ``fused_eval=True``, seeded weights and randomized BatchNorm statistics:
   in bf16 one 4096 x 4096 tile over a (1, 4) mesh and a B=2 batch of 2048 x
   2048 tiles over a (2, 2) mesh, each rank's block within 2e-2 of the
   largest |logit| of the unsharded forward of its images, which each rank
   runs alone on the card, with argmax agreeing on at least 99.5% of its
   pixels; in float32 (TF32 off) 512 px over (1, 4) and (2, 2), 32 px
   (whole levels) over (1, 4) and a ``"dilated"`` module (run as the naive
   one) within 1e-5 of the largest |logit|.  In every case each block is bit
   for bit a one-process witness of the ranks' arithmetic: the same forward
   with every conv computed as the ranks' row blocks with their halo rows
   (cuDNN's algorithms at the ranks' shapes, which move bf16 roundings and
   so argmax on near-tied logits).  Each ``conv_bn_relu`` launch of the
   sharded forward, on the rank's rows with the neighbours' rows attached
   (up to 1026 x 4096), is held against the kernel's plain version on the
   same inputs at phase 3's tolerance.  Every rank's block on the card in
   the expected shape, finite, 2 ``conv_bn_relu`` launches and nothing else
   a forward, the same exchanges on every rank, and where every level is
   split one halo all-reduce per window layer (45).  A gaps line comes
   before the checks;
   a ``phase 18`` line prints the exchanges (calls, bytes) a forward, the
   level plan and the wall times with the card, as correctness runs: four
   ranks share one card and gloo stages through the host.
18b. (after 18, in a spawned process of its own, which spawns four ranks)
   ``spatial_forward`` of the other segmentation models over four gloo
   ranks sharing the card: the seven other ``create_model`` families at
   resnet34, DeepLabV3Plus at mobilenet_v2 and ``create_uda_model``'s
   ``UDASegmentationModel`` (resnet50), 23 classes, seeded weights and
   randomized BatchNorm statistics.  In float32 (TF32 off) 512 px at B=2
   over (1, 4) and (2, 2) and 64 px over (1, 4) (the /32 level whole), each
   rank's block within 1e-5 of the largest |logit| of the unsharded forward
   of its images, which the rank runs alone; in bf16 one 2048 x 2048 tile
   over (1, 4) within phase 18's 2e-2 of it, and bit for bit a one-process
   witness of the ranks' arithmetic (every conv as the ranks' row blocks
   with their halos, those inside ``spatial.whole`` on the whole level), so
   argmax agrees with the witness on at least 99.5% of the rank's pixels;
   the argmax against the plain forward is printed, not held (cuDNN's bf16
   convs at the ranks' shapes move near-tied random-weight logits: 98.75%
   for FPN, ``PERF.md``).  Every block on the card in the expected shape and
   finite, the same exchanges on every rank, and no launch of any kernel
   (none lies on these paths).  A gaps line comes before the checks; a
   ``phase 18b`` line prints per model the halo, level and mean all-reduces
   (calls, bytes) of a forward, a rank's peak memory in the sharded and in
   the whole forward, and the wall times, as correctness runs.
The script's own wall time is printed before the ``kernels`` line.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import collections
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,       # dense bf16 tensor cores
                  torch.float32: 67e12}         # f32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SLICE_SHAPES = [(32, 256, 256, 32, 32), (32, 512, 512, 16, 16)]
RAGGED_SHAPE = (2, 18, 50, 24, 20)
# bf16 tiles are 8x32 output pixels, K = Cin padded to 16 or 32, N = Cout to 8s
EDGE_SHAPES = [(3, 7, 9, 3, 16), (2, 33, 100, 16, 16), (1, 9, 70, 32, 8),
               (1, 256, 256, 32, 32), (1, 512, 512, 16, 16)]
SEED = 0
PORT = "uda_aerial_semantic_segmentation_research_tpu_torch"
JAX_OPS = "uda_aerial_semantic_segmentation_research_tpu/ops"
TRAIN_BATCH, TRAIN_STEPS, TILE, CLASSES = 32, 5, 512, 23
L2_BYTES = 50 * 2 ** 20                         # H100 L2
# BatchNorm inputs of the B=32 train step (NHWC shape: BatchNorms), checked
# against the step's own census in phase 5
BN_SHAPES = {(32, 16, 16, 512): 7, (32, 32, 32, 256): 15, (32, 64, 64, 128): 11,
             (32, 128, 128, 64): 8, (32, 256, 256, 32): 2, (32, 256, 256, 64): 1,
             (32, 512, 512, 16): 2}
# BatchNorm inputs of the B=32 mobilenet_v2 U-Net step whose rows hold no
# power of two of 16-byte vectors in bf16 (42 of its 62; the bulk path takes
# them, as it takes every power of two), and DeepLabV3Plus's
# low_project at resnet34 (NHWC shape: BatchNorms; phase 14 checks them
# against its census)
MOBILENET_UNET_WIDENED = {(32, 128, 128, 24): 2, (32, 256, 256, 96): 1, (32, 128, 128, 96): 1,
                          (32, 32, 32, 96): 3, (32, 128, 128, 144): 3, (32, 64, 64, 144): 1,
                          (32, 16, 16, 160): 3, (32, 64, 64, 192): 5, (32, 32, 32, 192): 1,
                          (32, 16, 16, 320): 1, (32, 32, 32, 384): 8, (32, 32, 32, 576): 5,
                          (32, 16, 16, 576): 1, (32, 16, 16, 960): 6, (32, 16, 16, 1280): 1}
DEEPLAB_WIDENED = {(32, 128, 128, 48): 1}
# untimed sums checks: the generic path (bf16 C=20: 40-byte rows; C=3;
# f32 C=1280: 320 vectors a row), rows of 3 to 160 vectors (C=24 .. 1280;
# several stages at 3 and 160), ragged, odd row counts, M=1 on both paths,
# C=16 / 512 off the step's shapes, many rows
SUMS_EDGE_SHAPES = [(3, 7, 5, 24), (1, 16), (1, 512), (1, 24), (2, 1000, 24), (4, 9, 3),
                    (5, 3, 16), (70000, 32), (3, 7, 5, 20), (7, 960), (2, 700, 1280)]
# what the kernels line gives for each extra sums shape
PER_SHAPE_KEYS = ("shape", "sums_ms", "dual_ms", "sums_bound_ms", "dual_bound_ms",
                  "sums_kernel_ms", "dual_kernel_ms", "sums_plain_ms", "dual_plain_ms",
                  "sums_library_ms", "dual_library_ms", "max_rel_err")
# device functions grouped by name (first match wins)
PROFILE_CATEGORIES = [
    ("conv_bn_relu kernel", ("conv_bn_relu", "fold_moments")),
    ("fused_cross_entropy kernels", ("ce_fwd_kernel", "ce_bwd_kernel", "ce_fold_kernel")),
    ("channel_sums kernels", ("channel_sums_bulk_kernel", "channel_sums_generic_kernel")),
    ("dihedral_normalize kernel", ("dihedral_normalize_",)),
    ("optimizer (foreach Adam, clip)", ("multi_tensor_apply",)),
    ("augmentation sorts, pads, index copies, bilinear resize",
     ("sort", "Sort", "_pad", "bilinear", "index_", "indexFunc", "index_elementwise")),
    ("argmax, confusion matrix, gathers / scatters", ("ArgMaxOps", "scatter_gather")),
    ("cuDNN convolution", ("cudnn", "cutlass", "xmma", "sm90_", "conv")),
    ("nearest upsample", ("upsample",)),
    ("concat", ("CatArray", "cat_")),
    ("max pool", ("pool",)),
    ("copy / dtype cast", ("copy",)),
    ("elementwise (BatchNorm, ReLU, add, normalize)", ("elementwise",)),
    ("reduction", ("reduce",)),
]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, inner: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time per call of ``fn`` over ``reps`` runs of
    ``inner`` calls back to back: the device's time, not the host's launch
    overhead (as long as the host enqueues faster than the device runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(b, h, w, ci, co, dtype, affine):
    """Least time (ms) for the function: each input read once, the output
    written once, vs its multiply-adds at the peak rate of ``dtype``."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * w * (ci + co) * elt + 9 * ci * co * 4 + (8 * ci if affine else 0)
    ops = 2 * b * h * w * 9 * ci * co + (3 * b * h * w * ci if affine else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(gen, b, h, w, ci, co, dtype):
    x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(dtype)
    k3 = 0.1 * torch.randn(3, 3, ci, co, generator=gen, device="cuda")
    scale = 1.0 + 0.1 * torch.randn(ci, generator=gen, device="cuda")
    shift = 0.1 * torch.randn(ci, generator=gen, device="cuda")
    scale[0], scale[1] = 0.0, -0.5          # zero and negative BN scale
    return x, k3, scale, shift


def check_kernel(conv_bn_relu, reference, gen, shape, dtype, affine, timed):
    """Kernel vs plain version on one case (y within one bf16 ulp or 1e-4 in
    f32, moments within 1e-3 * sum|y|, two launches bit-identical); returns a
    result dict, with times when ``timed``."""
    b, h, w, ci, co = shape
    x, k3, scale, shift = kernel_inputs(gen, *shape, dtype)
    sc, sh = (scale, shift) if affine else (None, None)
    y, mom = conv_bn_relu(x, k3, sc, sh, moments=True)
    y_plain = conv_bn_relu(x, k3, sc, sh)
    y_again, mom_again = conv_bn_relu(x, k3, sc, sh, moments=True)
    torch.cuda.synchronize()
    if not (torch.equal(y, y_again) and torch.equal(mom, mom_again)):
        raise AssertionError(f"two launches differ at {shape} {dtype}")
    y_ref, mom_ref = reference(x, k3, sc, sh, moments=True)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    if not torch.equal(y, y_plain):
        raise AssertionError("moments=True changed y")
    mom_bound = 1e-3 * y_ref.float().abs().sum((0, 1, 2))
    if not torch.all((mom - mom_ref).abs() <= mom_bound):
        raise AssertionError(f"moments off by {(mom - mom_ref).abs().max().item()}")
    res = dict(shape=list(shape), dtype=str(dtype).split(".")[-1], affine=affine,
               tolerance=f"{tol} (atol and rtol); moments 1e-3 * sum|y|; two launches "
                         "bit-identical",
               max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
               moments_max_abs_err=(mom - mom_ref).abs().max().item())
    if timed:
        act = x if not affine else torch.relu(x.float() * scale + shift).to(dtype)
        act = act.permute(0, 3, 1, 2)                     # channels_last NCHW view
        w_oihw = k3.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        res["kernel_ms"] = device_ms(lambda: conv_bn_relu(x, k3, sc, sh))
        res["plain_ms"] = device_ms(lambda: reference(x, k3, sc, sh))
        res["library_ms"] = device_ms(lambda: F.conv2d(act, w_oihw, padding=1))
        res["bound_ms"], res["bound_by"] = bound(b, h, w, ci, co, dtype, affine)
        res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
        res["kernel_single_launch_ms"] = time_ms(lambda: conv_bn_relu(x, k3, sc, sh))
        res["library_single_launch_ms"] = time_ms(lambda: F.conv2d(act, w_oihw, padding=1))
    print("kernel check", json.dumps(res), flush=True)
    return res


def profile_forward(fn, reps: int = 3, top: int = 8, categories=None):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler).

    Returns per-call device ms (kernels, copies and fills on the device),
    the device busy share (union of device intervals over the host wall
    time of the window), and the ``top`` device functions by time; device
    functions grouped by ``categories`` (``PROFILE_CATEGORIES`` by default).
    """
    categories = PROFILE_CATEGORIES if categories is None else categories
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, count = [], {}, collections.Counter()
    for e in prof.events():
        if on_device(e):
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
            count[e.name] += 1
    if not spans:
        return {"device_ms_per_call": "not measured"}
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    total_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    by_category, launches = {}, collections.Counter()
    for name, us in by_name.items():
        cat = next((c for c, keys in categories
                    if any(k in name for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3 / reps
        launches[cat] += count[name]
    other = sorted(((us, name) for name, us in by_name.items()
                    if not any(k in name for _, keys in categories for k in keys)),
                   reverse=True)[:4]
    return {"device_ms_per_call": total_us / 1e3 / reps,
            "other_top": [{"ms": us / 1e3 / reps, "launches": count[name] / reps,
                           "name": name[:80]} for us, name in other],
            "busy_share": busy_us / wall_us,
            "by_category_ms": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "by_category_launches": {c: n / reps for c, n in launches.most_common()},
            "top_kernels": [{"ms": us / 1e3 / reps, "share": us / total_us,
                             "name": name[:100]} for name, us in ranked]}


def randomize_batch_norms_(model, gen):
    """Non-trivial eval-mode statistics, so the fold is exercised."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
        BatchNorm,
    )

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.scale.numel()
                sign = torch.where(torch.rand(n, generator=gen) < 0.2, -1.0, 1.0)
                m.scale.copy_(sign * (0.5 + 0.5 * torch.rand(n, generator=gen)))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.var.copy_(0.5 + torch.rand(n, generator=gen))


def roofline(nbytes, ops, dtype=torch.float32):
    """Least time (ms): bytes over the memory rate vs operations over the
    peak rate of ``dtype``; and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def rotation(make, call_bytes):
    """Copies of one call's inputs (the first from ``make`` as well) that
    together exceed twice the L2, so a run through them reads from HBM."""
    return [make() for _ in range(max(1, -(-2 * L2_BYTES // call_bytes)))]


def cycling(fn, inputs):
    """``fn`` on the next tuple of ``inputs`` at each call."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def sums_inputs(gen, shape, dtype, dy_dtype=None):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dy_dtype or dtype)
    return dy, x


def check_sums(ops, gen, shape, dtype, timed, dy_dtype=None, parent=None):
    """channel_sums / channel_dual_sums vs their plain versions on one
    (..., C) shape; ``dy_dtype`` other than ``dtype`` for the mixed dual
    form.  Tolerance: 1e-5 of sum|terms| per channel (float32 sums taken in
    another order); two launches bit-identical.  Timed: 20 launches per event
    pair over rotating copies of the inputs (> 2x the L2: cold, as in the
    step), the single-launch time beside; ``parent`` (an older commit's
    kernels, ``parent_sums``) timed the same way and by the profiler, in
    turns with the new ones, the library's kernel time beside."""
    dy, x = sums_inputs(gen, shape, dtype, dy_dtype)
    dims = tuple(range(len(shape) - 1))
    got, dual = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    again, dual_again = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(dual, dual_again)):
        raise AssertionError(f"two launches differ at {shape} {dtype}")
    ref, dual_ref = ops.channel_sums_reference(x), ops.channel_dual_sums_reference(dy, x)
    x32, dy32 = x.float(), dy.float()
    terms = torch.stack([x32.abs().sum(dims), (x32 * x32).sum(dims)])
    dual_terms = torch.stack([dy32.abs().sum(dims), (dy32 * x32).abs().sum(dims)])
    del x32, dy32
    rel = lambda a, r, t: ((a - r).abs() / (t + 1e-6)).max().item()
    err = max(rel(got, ref, terms), rel(dual, dual_ref, dual_terms))
    if not err <= 1e-5:
        raise AssertionError(f"channel sums off by {err} of sum|terms| at {shape} {dtype}")
    res = dict(kernel="channel_sums", shape=list(shape), dtype=dtype_name(dtype),
               dy_dtype=dtype_name(dy.dtype),
               tolerance="1e-5 * sum|terms|; two launches bit-identical", max_rel_err=err,
               max_abs_err=max((got - ref).abs().max().item(),
                               (dual - dual_ref).abs().max().item()))
    if parent is not None:
        p_got, p_dual = parent(x), parent(dy, x)
        res["parent_max_rel_err"] = max(rel(p_got, ref, terms), rel(p_dual, dual_ref, dual_terms))
    if timed:
        n, c = x.numel(), shape[-1]
        sums_in = [(x,)] + rotation(lambda: (x.clone(),), n * x.element_size())[1:]
        dual_in = [(dy, x)] + rotation(lambda: (dy.clone(), x.clone()),
                                       n * (x.element_size() + dy.element_size()))[1:]
        if parent is not None:       # parent, new, new, parent; event pairs and profiler
            for key, new_fn, inputs in (("sums", ops.channel_sums, sums_in),
                                        ("dual", ops.channel_dual_sums, dual_in)):
                for time_fn, name in ((device_ms, ""), (kernel_ms, "kernel_")):
                    t = [time_fn(cycling(f, inputs)) for f in (parent, new_fn, new_fn, parent)]
                    res[f"{key}_parent_{name}ms"] = (t[0] + t[3]) / 2
                    res[f"{key}_{name}ms"] = (t[1] + t[2]) / 2
                    res[f"{key}_{name}turns_ms"] = t
        else:
            res["sums_ms"] = device_ms(cycling(ops.channel_sums, sums_in))
            res["dual_ms"] = device_ms(cycling(ops.channel_dual_sums, dual_in))
            res["sums_plain_ms"] = device_ms(cycling(ops.channel_sums_reference, sums_in))
            res["dual_plain_ms"] = device_ms(cycling(ops.channel_dual_sums_reference, dual_in))
        res["sums_library_ms"] = device_ms(
            cycling(lambda t: torch.var_mean(t, dim=dims), sums_in))
        res["dual_library_ms"] = device_ms(cycling(
            lambda d, t: (d.sum(dims, dtype=torch.float32),
                          (d * t).sum(dims, dtype=torch.float32)), dual_in))
        if parent is None:
            res["sums_single_launch_ms"] = time_ms(lambda: ops.channel_sums(x))
            res["dual_single_launch_ms"] = time_ms(lambda: ops.channel_dual_sums(dy, x))
            res["sums_kernel_ms"] = kernel_ms(cycling(ops.channel_sums, sums_in))
            res["dual_kernel_ms"] = kernel_ms(cycling(ops.channel_dual_sums, dual_in))
        else:
            res["sums_library_kernel_ms"] = kernel_ms(
                cycling(lambda t: torch.var_mean(t, dim=dims), sums_in))
            res["dual_library_kernel_ms"] = kernel_ms(cycling(
                lambda d, t: (d.sum(dims, dtype=torch.float32),
                              (d * t).sum(dims, dtype=torch.float32)), dual_in))
        del sums_in, dual_in
        res["sums_bound_ms"], res["bound_by"] = roofline(n * x.element_size() + 8 * c, 4 * n)
        res["dual_bound_ms"], _ = roofline(n * (x.element_size() + dy.element_size()) + 8 * c,
                                           4 * n)
        res["sums_share_of_bound"] = res["sums_bound_ms"] / res["sums_ms"]
        res["dual_share_of_bound"] = res["dual_bound_ms"] / res["dual_ms"]
    print("kernel check", json.dumps(res), flush=True)
    return res


def on_device(event) -> bool:
    """A kernel, copy or fill on the device; not a user annotation that the
    profiler mirrors onto the device's timeline (``Optimizer.step#...``)."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def device_events(fn, calls: int = 20, windows: int = 12):
    """(name, µs) of every device event (kernels, copies, fills) of ``calls``
    calls of ``fn`` under torch.profiler, after one call outside the window.
    A spin kernel on each side of the calls is left out.  The profiler can
    drop events (a whole window's, at times; in some processes one of every
    window) but never adds any: a window is taken again, up to ``windows``
    times, until its count is a whole number of events per call or two
    windows in a row came out equally short (a loss the profiler repeats,
    which more windows do not undo), and the fullest window is returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, last = [], None
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(20000)
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                  if on_device(e) and "spin_kernel" not in e.name]
        if len(events) > len(best):
            best = events
        if (best and len(best) % calls == 0) or (events and len(events) == last):
            break
        last = len(events)
    return best


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time (µs) to enqueue one call of ``fn``: the wrapper's checks,
    plan, allocation and launch, with the device far from saturated."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` from the profiler's kernel durations
    (no host launch overhead, no gaps between launches): the mean duration
    of each device function, summed over the functions of a call."""
    by_name = collections.defaultdict(list)
    for name, us in device_events(fn, calls):
        by_name[name].append(us)
    if not by_name:
        # the profiler can lose every window (CUPTI); CUDA events over calls
        # back to back stand in, the gaps between launches included
        print("kernel_ms: the profiler saw no device event in any window; timed with "
              "CUDA events", flush=True)
        return device_ms(fn, inner=calls)
    return sum(statistics.fmean(v) for v in by_name.values()) / 1e3


def device_kernels_per_call(fn, prefix, calls: int = 20) -> float:
    """Device events per call of ``fn``; each must be a kernel named ``prefix``...
    The profiler can drop events but never adds any, and in some processes it
    drops one of every window: where no window of ``calls`` calls comes out
    whole, the count is that of the fullest window of ``2 * calls`` calls less
    that of ``calls``, over ``calls`` (a constant loss a window cancels)."""
    counts = []
    for n in (calls, 2 * calls):
        names = [name for name, _ in device_events(fn, n)]
        if not all(prefix in name for name in names):
            raise AssertionError(f"other device work in {prefix} calls: {set(names)}")
        counts.append(len(names))
        if len(names) % calls == 0:
            return len(names) / n
    print(f"device_kernels_per_call: {prefix} windows of {calls} and {2 * calls} calls "
          f"short: {counts[0]} and {counts[1]} events", flush=True)
    return (counts[1] - counts[0]) / calls


def check_sums_launches(ops, gen):
    """One device kernel per call (profiler), 1,000 calls in a row give the
    same bits (the ticket counter is re-armed), and two streams at once
    (one counter each) agree with the plain versions."""
    dy, x = sums_inputs(gen, (32, 32, 32, 256), torch.bfloat16)
    _, odd = sums_inputs(gen, (3, 7, 5, 20), torch.bfloat16)      # 40-byte rows: generic path
    dy3, x3 = sums_inputs(gen, (2, 1000, 24), torch.bfloat16)     # 3 vectors a row
    dy120, x120 = sums_inputs(gen, (32, 16, 16, 960), torch.bfloat16)   # 120 vectors a row
    per_call = {name: device_kernels_per_call(fn, "channel_sums_") for name, fn in (
        ("channel_sums", lambda: ops.channel_sums(x)),
        ("channel_dual_sums", lambda: ops.channel_dual_sums(dy, x)),
        ("channel_sums generic", lambda: ops.channel_sums(odd)),
        ("channel_sums G=3", lambda: ops.channel_sums(x3)),
        ("channel_dual_sums G=3", lambda: ops.channel_dual_sums(dy3, x3)),
        ("channel_sums G=120", lambda: ops.channel_sums(x120)),
        ("channel_dual_sums G=120", lambda: ops.channel_dual_sums(dy120, x120)))}
    if any(v != 1 for v in per_call.values()):
        raise AssertionError(f"device kernels per call: {per_call}")
    host_us = {name: host_us_per_call(fn) for name, fn in (
        ("channel_sums", lambda: ops.channel_sums(x)),
        ("channel_dual_sums", lambda: ops.channel_dual_sums(dy, x)))}
    first, first_dual = ops.channel_sums(x), ops.channel_dual_sums(dy, x)
    runs = [(ops.channel_sums(x), ops.channel_dual_sums(dy, x)) for _ in range(500)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, first) and torch.equal(b, first_dual) for a, b in runs):
        raise AssertionError("1,000 calls in a row do not give the same bits")
    dy2, x2 = sums_inputs(gen, (32, 64, 64, 128), torch.bfloat16)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(50):
        with torch.cuda.stream(streams[0]):
            outs[0].append(ops.channel_sums(x))
        with torch.cuda.stream(streams[1]):
            outs[1].append(ops.channel_dual_sums(dy2, x2))
    torch.cuda.synchronize()
    ref = ops.channel_sums_reference(x)
    ref_dual = ops.channel_dual_sums_reference(dy2, x2)
    for got, r in ((outs[0], ref), (outs[1], ref_dual)):
        if not all(torch.equal(g, got[0]) for g in got):
            raise AssertionError("two streams: calls on one stream differ")
        torch.testing.assert_close(got[0], r, rtol=1e-5, atol=1e-2)
    res = {"device_kernels_per_call": per_call, "host_us_per_call": host_us,
           "calls_in_a_row": 1000,
           "two_streams": "50 channel_sums + 50 channel_dual_sums, bit-identical per stream"}
    print("kernel check", json.dumps({"kernel": "channel_sums launches", **res}), flush=True)
    return res


def parent_sums(source):
    """The channel_sums kernels of an older commit: its ``csrc/channel_sums.cu``
    (``source``) built with the port's nvcc flags, launched through that
    commit's C interface (``channel_sums_max_clusters``, the 12-argument
    ``channel_sums_launch``) on the grid that its own ``plan`` gives, read
    from its ``ops/channel_sums.py`` copied beside the source (same name,
    ``.py``): fn(x) or fn(dy, x)."""
    import ctypes
    import importlib.util
    from pathlib import Path

    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    source = Path(source).resolve()
    planner = source.with_suffix(".py")
    spec = importlib.util.spec_from_file_location("parent_channel_sums", planner)
    parent_ops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_ops)
    out = source.parent / "libchannel_sums_parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(out), str(source)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    i32, i64, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.channel_sums_max_clusters.argtypes = [i32, i32, i32]
    lib.channel_sums_max_clusters.restype = i32
    lib.channel_sums_launch.argtypes = [ptr] * 4 + [i32, i32, i64, i32, i32, i64, i32, ptr]
    lib.channel_sums_launch.restype = i32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limits, scratch = {}, [torch.zeros(1 << 16, dtype=torch.float32, device="cuda")]

    def call(a, b=None):
        c = a.shape[-1]
        m = a.numel() // c
        a_bf16 = int(a.dtype == torch.bfloat16)
        b_kind = -1 if b is None else int(b.dtype == torch.bfloat16)
        if (a_bf16, b_kind) not in limits:
            counts = [min(lib.channel_sums_max_clusters(a_bf16, b_kind, k), sms // k)
                      for k in parent_ops.CLUSTER_SIZES]
            limits[a_bf16, b_kind] = tuple(max(n, 0) for n in counts)
        p = parent_ops.plan(m, c, a.element_size(), 0 if b is None else b.element_size(),
                            a.data_ptr() % 16 == 0 and (b is None or b.data_ptr() % 16 == 0),
                            limits[a_bf16, b_kind], sms)
        floats = parent_ops.SCRATCH_HEAD + p.partial_rows * 2 * c
        if scratch[0].numel() < floats:         # the counter of a new buffer starts at 0
            torch.cuda.synchronize()
            scratch[0] = torch.zeros(floats, dtype=torch.float32, device="cuda")
        res = torch.empty((2, c), dtype=torch.float32, device=a.device)
        err = lib.channel_sums_launch(
            a.data_ptr(), None if b is None else b.data_ptr(), scratch[0].data_ptr(),
            res.data_ptr(), a_bf16, max(b_kind, 0), m, c, p.blocks, p.rows_per_block, p.cluster,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent channel_sums failed: CUDA error {err}")
        return res

    return call


def widened_per_step(rows, census) -> dict:
    """Kernel, event-pair, bound and library ms a step over ``census``
    (shape: BatchNorms), sums plus dual, from ``check_sums`` rows."""
    by_shape = {tuple(r["shape"]): r for r in rows}
    total = lambda *keys: sum(census[s] * sum(by_shape[s][k] for k in keys) for s in census)
    out = {"inputs": sum(census.values()), "shapes": len(census),
           "kernel_ms": total("sums_kernel_ms", "dual_kernel_ms"),
           "ms": total("sums_ms", "dual_ms"),
           "bound_ms": total("sums_bound_ms", "dual_bound_ms"),
           "library_ms": total("sums_library_ms", "dual_library_ms"),
           "forward_kernel_ms": total("sums_kernel_ms"), "dual_kernel_ms": total("dual_kernel_ms")}
    if all("sums_parent_kernel_ms" in by_shape[s] for s in census):
        out["parent_kernel_ms"] = total("sums_parent_kernel_ms", "dual_parent_kernel_ms")
        out["parent_ms"] = total("sums_parent_ms", "dual_parent_ms")
    return out


def compare_sums_with_parent(sums_ops, source, card):
    """The new and the parent's sums kernels (bf16, same inputs, 20 launches
    per event pair on rotating cold copies, and the profiler's kernel time,
    each in turns: parent, new, new, parent) at the resnet34 step's 7
    BatchNorm shapes, the mobilenet_v2 U-Net's and DeepLabV3Plus's widened
    shapes, and the resnet50 U-Net's, its head's and the discriminator's;
    the mobilenet U-Net's widened inputs a step beside their bound and the
    library."""
    parent = parent_sums(source)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sets = {"resnet34_step": BN_SHAPES, "mobilenet_unet_widened": MOBILENET_UNET_WIDENED,
            "deeplab_widened": DEEPLAB_WIDENED,
            "resnet50_head_discriminator": {s: 1 for s in sorted(
                set(UDA_UNET_BN_SHAPES) | set(UDA_HEAD_BN_SHAPES) | set(DISC_BN_SHAPES))
                if s not in BN_SHAPES}}
    rows = {}
    for shapes in sets.values():
        for shape in sorted(shapes):
            if shape not in rows:
                rows[shape] = check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True,
                                         parent=parent)
    step = lambda key: sum(rows[s][key] * n for s, n in BN_SHAPES.items())
    bound = step("sums_bound_ms") + step("dual_bound_ms")
    new_ms = step("sums_ms") + step("dual_ms")
    old_ms = step("sums_parent_ms") + step("dual_parent_ms")
    keys = ("shape", "sums_ms", "sums_parent_ms", "dual_ms", "dual_parent_ms",
            "sums_share_of_bound", "dual_share_of_bound", "sums_turns_ms", "dual_turns_ms",
            "sums_kernel_turns_ms", "dual_kernel_turns_ms",
            "sums_kernel_ms", "sums_parent_kernel_ms", "dual_kernel_ms", "dual_parent_kernel_ms",
            "sums_bound_ms", "dual_bound_ms", "sums_library_ms", "dual_library_ms",
            "sums_library_kernel_ms", "dual_library_kernel_ms", "max_rel_err",
            "parent_max_rel_err")
    print(json.dumps({"sums_vs_parent": {
        "per_step_ms": new_ms, "parent_per_step_ms": old_ms, "bound_ms": bound,
        "share_of_bound": bound / new_ms, "parent_share_of_bound": bound / old_ms,
        "kernel_per_step_ms": step("sums_kernel_ms") + step("dual_kernel_ms"),
        "parent_kernel_per_step_ms": step("sums_parent_kernel_ms") + step("dual_parent_kernel_ms"),
        "mobilenet_unet_widened_per_step": widened_per_step(list(rows.values()),
                                                            MOBILENET_UNET_WIDENED),
        "per_shape": {name: [{k: rows[s][k] for k in keys} | {"batch_norms": n}
                             for s, n in sorted(shapes.items())]
                      for name, shapes in sets.items()},
        "card": card}}), flush=True)


# flags of each batch class at the train step's shape (B=32): every group
# element, only identity and flips (no shared-memory transpose), only transposes
DIHEDRAL_CLASSES = {"mixed": tuple(range(8)), "untransposed": (0, 2, 4, 6),
                    "transposed": (1, 3, 5, 7)}
# untimed dihedral checks: (B, S, C, mask dtype, unaligned view, int64 flags
# with high bits): the generic path (S off 16, C other than 3, wide masks, an
# unaligned pointer), units cut by the image's edge (S=80: a 16-row band;
# S=1040: a 16-column unit), blocks that reuse their stages (B=70), B=1, S=1
DIHEDRAL_EDGES = [(33, 50, 3, torch.uint8, False, False), (1, 512, 3, torch.uint8, True, False),
                  (2, 1040, 3, torch.uint8, False, True), (3, 80, 3, None, False, False),
                  (4, 33, 1, torch.int32, False, False), (2, 16, 8, torch.int64, False, True),
                  (1, 1, 3, torch.uint8, False, False), (70, 512, 3, torch.uint8, False, True)]


def dihedral_flags(host_rng, cls, b):
    """int32 (b,) flags of class ``cls``, each of its elements present."""
    pick = np.asarray(DIHEDRAL_CLASSES[cls], np.int32)
    flags = pick[host_rng.permutation(b) % len(pick)]
    if set(flags.tolist()) != set(pick.tolist()):
        raise AssertionError(f"not every element of {cls} is present")
    return torch.from_numpy(flags).cuda()


def dihedral_case(host_rng, b, s, c, mask_dtype, unaligned, wide_flags):
    """Images (an unaligned view when asked), flags, masks for one check."""
    n = b * s * s * c
    base = torch.from_numpy(host_rng.integers(0, 256, n + 1, dtype=np.uint8)).cuda()
    images = (base[1:] if unaligned else base[:n]).view(b, s, s, c)
    flags = torch.from_numpy(host_rng.integers(0, 8, b).astype(np.int32)).cuda()
    if wide_flags:  # bits above the third are ignored, in either word
        flags = flags.long() + (torch.arange(b, device="cuda") % 5 << 3) + (1 << 40)
    masks = None if mask_dtype is None else torch.from_numpy(
        host_rng.integers(0, CLASSES, (b, s, s)).astype(np.int32)).cuda().to(mask_dtype)
    return images, flags, masks


def check_dihedral(ops, host_rng, parent=None):
    """dihedral_normalize vs its plain version at the train step's shape with
    uint8 masks, for a batch of every group element, of identity and flips
    only, and of transposes only, ``normalize`` both ways: bit-exact images
    and masks, two launches bit-identical; then the edges (DIHEDRAL_EDGES).
    Timed per class: 20 launches per event pair over rotating input copies
    larger than twice the L2 (cold, as in the step), the profiler's kernel
    duration, one launch per event pair, and the plain version; ``parent``
    (an older kernel) timed the same way, in turns with the new one."""
    b = TRAIN_BATCH
    images = torch.from_numpy(host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8)).cuda()
    masks = torch.from_numpy(host_rng.integers(0, CLASSES, (b, TILE, TILE), dtype=np.uint8)).cuda()
    flag_sets = {cls: dihedral_flags(host_rng, cls, b) for cls in DIHEDRAL_CLASSES}
    max_err = 0.0
    for cls, flags in flag_sets.items():
        for normalize in (False, True):
            x, m = ops.dihedral_normalize(images, flags, masks, normalize=normalize)
            x2, m2 = ops.dihedral_normalize(images, flags, masks, normalize=normalize)
            torch.cuda.synchronize()
            if not (torch.equal(x, x2) and torch.equal(m, m2)):
                raise AssertionError(f"two dihedral_normalize launches differ ({cls})")
            x_ref, m_ref = ops.dihedral_normalize_reference(images, flags, masks,
                                                            normalize=normalize)
            if not (torch.equal(x, x_ref) and torch.equal(m, m_ref)):
                raise AssertionError(f"dihedral_normalize({cls}, normalize={normalize}) "
                                     "is not bit-exact")
            max_err = max(max_err, (x - x_ref).abs().max().item())
            if parent is not None:
                px, pm = parent(images, flags, masks, normalize)
                if not (torch.equal(px, x_ref) and torch.equal(pm, m_ref)):
                    raise AssertionError(f"the parent kernel is not bit-exact ({cls})")
            del x, m, x2, m2, x_ref, m_ref
    edges = []
    for case in DIHEDRAL_EDGES:
        im, fl, mk = dihedral_case(host_rng, *case)
        for normalize in (False, True) if im.shape[-1] == 3 else (False,):
            x, m = ops.dihedral_normalize(im, fl, mk, normalize=normalize)
            x_ref, m_ref = ops.dihedral_normalize_reference(im, fl, mk, normalize=normalize)
            if not (torch.equal(x, x_ref) and (mk is None or torch.equal(m, m_ref))):
                raise AssertionError(f"dihedral_normalize is not bit-exact at {case}")
        edges.append([*case[:3], dtype_name(case[3]) if case[3] else None, *case[4:]])
    n_img, n_mask = images.numel(), masks.numel()
    res = dict(kernel="dihedral_normalize", shape=list(images.shape), dtype="uint8",
               masks="uint8", tolerance="bit-exact; two launches bit-identical",
               max_abs_err=max_err, edges_bit_exact=edges, library_ms=None)
    res["bound_ms"], res["bound_by"] = roofline(5 * n_img + 5 * n_mask + 4 * b, 2 * n_img)
    copies = rotation(lambda: (images.clone(), masks.clone()), n_img + n_mask)
    new_fn = lambda fl: lambda im, mk: ops.dihedral_normalize(im, fl, mk)
    for cls, flags in flag_sets.items():
        inputs = [(images, masks)] + copies[1:]
        r = {}
        if parent is not None:       # parent, new, new, parent
            old_fn = lambda im, mk, fl=flags: parent(im, fl, mk)
            t = [device_ms(cycling(f, inputs))
                 for f in (old_fn, new_fn(flags), new_fn(flags), old_fn)]
            r["ms"], r["parent_ms"], r["turns_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t
            r["parent_kernel_ms"] = kernel_ms(cycling(old_fn, inputs))
        else:
            r["ms"] = device_ms(cycling(new_fn(flags), inputs))
            r["plain_ms"] = device_ms(cycling(
                lambda im, mk, fl=flags: ops.dihedral_normalize_reference(im, fl, mk), inputs))
        r["kernel_ms"] = kernel_ms(cycling(new_fn(flags), inputs))
        r["single_launch_ms"] = time_ms(lambda: ops.dihedral_normalize(images, flags, masks))
        r["share_of_bound"] = res["bound_ms"] / r["ms"]
        r["share_of_bound_kernel_time"] = res["bound_ms"] / r["kernel_ms"]
        res[cls] = r
    del copies
    mixed = flag_sets["mixed"]
    odd_images, odd_masks = images[:, :50, :50].contiguous(), masks[:, :50, :50].contiguous()
    res["device_kernels_per_call"] = {
        "bulk": device_kernels_per_call(lambda: ops.dihedral_normalize(images, mixed, masks),
                                        "dihedral_normalize_"),
        "generic": device_kernels_per_call(
            lambda: ops.dihedral_normalize(odd_images, mixed, odd_masks), "dihedral_normalize_")}
    if any(v != 1 for v in res["device_kernels_per_call"].values()):
        raise AssertionError(f"device kernels per call: {res['device_kernels_per_call']}")
    res["host_us_per_call"] = host_us_per_call(
        lambda: ops.dihedral_normalize(images, mixed, masks))
    print("kernel check", json.dumps(res), flush=True)
    return res


def check_dihedral_no_masks(ops, host_rng) -> dict:
    """dihedral_normalize without masks (the target batches of phases 2 and
    3) at the train step's shape, for each batch class and ``normalize``
    both ways: bit-exact against the plain version, no mask returned; timed
    for the mixed class as 20 launches per event pair on rotating cold
    copies, beside its plain version and its byte bound."""
    b = TRAIN_BATCH
    images = torch.from_numpy(host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8)).cuda()
    for cls in DIHEDRAL_CLASSES:
        flags = dihedral_flags(host_rng, cls, b)
        for normalize in (False, True):
            x, m = ops.dihedral_normalize(images, flags, None, normalize=normalize)
            x_ref, _ = ops.dihedral_normalize_reference(images, flags, None, normalize=normalize)
            if m is not None or not torch.equal(x, x_ref):
                raise AssertionError(f"dihedral_normalize without masks ({cls}, "
                                     f"normalize={normalize}) is not bit-exact")
    flags = dihedral_flags(host_rng, "mixed", b)
    n = images.numel()
    inputs = [(images,)] + rotation(lambda: (images.clone(),), n)[1:]
    res = dict(shape=list(images.shape), masks=None, tolerance="bit-exact", max_abs_err=0.0,
               ms=device_ms(cycling(lambda im: ops.dihedral_normalize(im, flags, None), inputs)),
               plain_ms=device_ms(cycling(
                   lambda im: ops.dihedral_normalize_reference(im, flags, None), inputs)))
    res["bound_ms"], res["bound_by"] = roofline(5 * n + 4 * b, 2 * n)
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    print("kernel check", json.dumps({"dihedral_normalize_no_masks": res}), flush=True)
    return res


def parent_dihedral(source):
    """An older dihedral_normalize.cu with the parent's C interface (int32
    flags, no plan), built with the port's nvcc flags: fn(images, flags,
    masks, normalize=False) with uint8 masks."""
    import ctypes
    import os

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "parent" / "libdihedral_normalize_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
                    str(out), os.fspath(source)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dihedral_normalize_launch.argtypes = [ptr] * 5 + [i32] * 5 + [f32] * 6 + [ptr]
    lib.dihedral_normalize_launch.restype = i32

    def call(images, flags, masks, normalize=False):
        b, s, _, c = images.shape
        x = torch.empty(images.shape, dtype=torch.float32, device=images.device)
        m = torch.empty(masks.shape, dtype=torch.int32, device=images.device)
        err = lib.dihedral_normalize_launch(
            images.data_ptr(), flags.data_ptr(), x.data_ptr(), masks.data_ptr(), m.data_ptr(),
            0, b, s, c, int(normalize), *Config.NORMALIZE_MEAN, *Config.NORMALIZE_STD,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent dihedral_normalize failed: CUDA error {err}")
        return x, m

    return call


def compare_dihedral_with_parent(ops, source, card):
    """The new and an older dihedral kernel at the train step's shape, same
    inputs, per batch class, 20 launches per event pair on rotating cold
    copies, in turns (parent, new, new, parent), and by kernel time."""
    res = check_dihedral(ops, np.random.default_rng(SEED), parent=parent_dihedral(source))
    print(json.dumps({"dihedral_vs_parent": {
        "bound_ms": res["bound_ms"],
        **{cls: res[cls] | {"parent_share_of_bound_kernel_time":
                            res["bound_ms"] / res[cls]["parent_kernel_ms"]}
           for cls in DIHEDRAL_CLASSES},
        "card": card}}), flush=True)


def augment_stages(augment, ops, cfg, images, masks, gen):
    """(stage name, function) of ``augment_batch``'s pieces in order, each on
    the previous piece's output (computed once here) and on the same draws:
    the draws themselves, the dihedral kernel with the cast to the compute
    dtype, the warps, each photometric stage, the float32 normalize."""
    n, shape = images.shape[0], tuple(images.shape)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]

    def draws():
        return (augment._sample_dihedral(gen, n, cfg),
                augment.sample_params(gen, shape, cfg, has_masks=True))

    abc, params = draws()
    flags = ops.flags_from_abc(*abc)
    front = lambda: ops.dihedral_normalize(images, flags, masks)
    x, m = front()
    x = x.to(dt)
    stages = [("draws", draws), ("dihedral kernel + cast", lambda: front()[0].to(dt))]
    if cfg.p_ssr > 0 or cfg.p_distort > 0:
        stages.append(("warps", lambda x=x, m=m: augment._warp_stage(x, m, params.warp, cfg)))
        x, m = stages[-1][1]()
    photometric = params.photometric
    for name, p, fn, d in (("noise", cfg.p_noise, augment._noise_stage, photometric.noise),
                           ("blur", cfg.p_blur, augment._blur_stage, photometric.blur),
                           ("colour", cfg.p_color, augment._color_stage, photometric.color),
                           ("hsv", cfg.p_hsv, augment._hsv_stage, photometric.hsv)):
        if p > 0:
            stages.append((name, lambda x=x, fn=fn, d=d: fn(x, d, cfg)))
            x = stages[-1][1]()
    mean, std = ops.imagenet_stats(images.device)
    stages.append(("normalize", lambda x=x: (x.float() - mean) / std))
    return stages


def time_augment_batch(augment, ops, host_rng, card):
    """The train step's front end at its shape, (32, 512, 512, 3) uint8 with
    uint8 masks, for the dihedral-only pipeline, WEAK and STRONG: draws from
    a generator on the card, as the step makes them.  Per pipeline: ms as 20
    calls per event pair on rotating cold copies, the profiler's device ms
    and launches of the whole call by kind and by stage (``augment_stages``),
    the peak memory a call adds, and one call under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises if anything
    in the call waits on the host."""
    images = torch.from_numpy(host_rng.integers(0, 256, (TRAIN_BATCH, TILE, TILE, 3),
                                                dtype=np.uint8)).cuda()
    masks = torch.from_numpy(host_rng.integers(0, CLASSES, (TRAIN_BATCH, TILE, TILE),
                                               dtype=np.uint8)).cuda()
    inputs = [(images, masks)] + rotation(lambda: (images.clone(), masks.clone()),
                                          images.numel() + masks.numel())[1:]
    n_img, n_mask = images.numel(), masks.numel()
    results = {}
    for name, cfg in (("dihedral only", dihedral_only(augment)), ("WEAK", augment.WEAK),
                      ("STRONG", augment.STRONG)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        fn = lambda im, mk, cfg=cfg, gen=gen: augment.augment_batch(gen, im, mk, cfg=cfg)
        ms = device_ms(cycling(fn, inputs))
        calls = 10
        by_kind, kind_launches = collections.defaultdict(float), collections.Counter()
        for ev, us in device_events(cycling(fn, inputs), calls):
            kind = next((c for c, keys in PROFILE_CATEGORIES if any(k in ev for k in keys)),
                        "other")
            by_kind[kind] += us / 1e3 / calls
            kind_launches[kind] += 1
        by_stage = {}
        for stage, stage_fn in augment_stages(augment, ops, cfg, images, masks, gen):
            events = device_events(stage_fn, calls)
            by_stage[stage] = {"device_ms": sum(us for _, us in events) / 1e3 / calls,
                               "launches": len(events) / calls}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(images, masks)
        torch.cuda.synchronize()
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        torch.cuda.set_sync_debug_mode("error")
        try:
            x, m = fn(images, masks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if (tuple(x.shape) != tuple(images.shape) or x.dtype != torch.float32
                or m.dtype != torch.int32 or not torch.isfinite(x).all()
                or m.min() < 0 or m.max() >= CLASSES):
            raise AssertionError(f"augment_batch {name} gave wrong images or masks")
        results[name] = {
            "shape": [TRAIN_BATCH, TILE, TILE, 3], "masks": "uint8",
            "compute_dtype": cfg.compute_dtype, "ms": ms,
            "device_ms": sum(by_kind.values()), "device_ms_by_kind": dict(by_kind),
            "launches": sum(kind_launches.values()) / calls,
            "launches_by_kind": {k: c / calls for k, c in kind_launches.items()},
            "by_stage": by_stage, "peak_added_gib": peak_gib,
            "sync_debug_call": "no host sync (set_sync_debug_mode('error') raised nothing)",
            # the function's least bytes: uint8 images and masks in, f32
            # images and int32 masks out
            "bound_ms": roofline(5 * n_img + 5 * n_mask, 0)[0],
            "timed_with": "20 calls per event pair, rotating copies > 2x L2", "card": card}
        print(json.dumps({"augment_batch": {name: results[name]}}), flush=True)
    return results


def check_clahe_card_vs_cpu(augment, x, clip, tiles):
    """CLAHE's pieces on the card against the CPU on the same float32 images
    ``x`` (on the card): LAB within 1e-4; the levels ``round(L * 255 /
    100)`` equal, or one apart where the CPU's ``L * 255 / 100`` lies within
    1e-3 of a half level (a one-ulp L decides such a tie; one level moves
    the tile's histogram, and so its LUT); then, fed the card's levels on
    both devices, the LUTs equal and the blended L within 1e-4.  Returns
    the images whose levels differ at a tie."""
    x = torch.clamp(x, 0.0, 1.0)
    lab = augment._rgb_to_lab(x)
    lab_cpu = augment._rgb_to_lab(x.cpu())
    for got, ref in zip(lab, lab_cpu):
        if not (got.cpu() - ref).abs().max().item() <= 1e-4:
            raise AssertionError("LAB on the card differs from the CPU")
    level = lambda L: torch.clamp(torch.round(L * (255.0 / 100.0)), 0, 255).to(torch.int32)
    levels, levels_cpu = level(lab[0]), level(lab_cpu[0])
    off = levels.cpu() != levels_cpu
    half = lab_cpu[0][off] * (255.0 / 100.0)
    if not (bool(((levels.cpu() - levels_cpu).abs() <= 1).all())
            and bool(((half - torch.floor(half) - 0.5).abs() < 1e-3).all())):
        raise AssertionError("CLAHE levels differ off a tie between the card and the CPU")
    lut = augment._clahe_lut(levels, clip, tiles)
    lut_cpu = augment._clahe_lut(levels.cpu(), clip.cpu(), tiles)
    if not torch.equal(lut.cpu(), lut_cpu):
        raise AssertionError("CLAHE LUTs differ between the card and the CPU")
    newl = augment._clahe_apply(levels, lut, tiles)
    newl_cpu = augment._clahe_apply(levels.cpu(), lut_cpu, tiles)
    if not (newl.cpu() - newl_cpu).abs().max() <= 1e-4:
        raise AssertionError("CLAHE blend differs between the card and the CPU")
    rgb = augment._lab_to_rgb(newl * (100.0 / 255.0), *lab[1:])
    rgb_cpu = augment._lab_to_rgb(newl.cpu() * (100.0 / 255.0), *(t.cpu() for t in lab[1:]))
    if not (rgb.cpu() - rgb_cpu).abs().max() <= 1e-4:
        raise AssertionError("LAB to RGB differs between the card and the CPU")
    return off.flatten(1).any(1), int(off.sum())


def check_augment_card_vs_cpu(augment, ops, host_rng):
    """Every stage of WEAK and STRONG (float32 pixel math) on the card against
    the same stage on the CPU, each fed the card's previous output, with the
    same draws (made on the host, every gate on: both images take every
    stage).  Tolerances: images 1e-4 after each stage up to colour, 1e-3
    after HSV (its hue divides by max - min, which is small for greyish
    pixels, so a 1e-5 input difference can move it by ~1e-4); masks may
    differ at nearest-neighbour ties of the warp coordinates (one float32
    ulp apart on the two devices), at most 1e-4 of the pixels.  CLAHE is
    held piece by piece (``check_clahe_card_vs_cpu``); an image whose CLAHE
    levels differ at a tie is left out of the colour stage's comparison."""
    images, masks = (torch.from_numpy(a) for a in train_batches(host_rng, 1, batch=2,
                                                                 tile=256)[0])
    result = {}
    for name in ("WEAK", "STRONG"):
        cfg = dataclasses.replace(getattr(augment, name), compute_dtype="float32")
        gen = torch.Generator().manual_seed(SEED)
        flags = ops.flags_from_abc(*augment._sample_dihedral(gen, 2, cfg))
        params = augment.sample_params(gen, tuple(images.shape), cfg, has_masks=True)
        every = lambda d: None if d is None else d._replace(do=torch.ones(2, dtype=torch.bool))
        host = augment.AugmentDraws(augment.WarpDraws(*(every(d) for d in params.warp)),
                                    augment.PhotometricDraws(*(every(d) for d in
                                                               params.photometric)))
        card = augment.draws_to(host, "cuda")
        photo = lambda p, stage: getattr(p.photometric, stage)
        stages = [("warps", lambda x, m, p: augment._warp_stage(x, m, p.warp, cfg), 1e-4),
                  ("noise", lambda x, m, p: (augment._noise_stage(x, photo(p, "noise"), cfg), m),
                   1e-4),
                  ("blur", lambda x, m, p: (augment._blur_stage(x, photo(p, "blur"), cfg), m),
                   1e-4),
                  ("colour", lambda x, m, p: (augment._color_stage(x, photo(p, "color"), cfg),
                                              m), 1e-4),
                  ("hsv", lambda x, m, p: (augment._hsv_stage(x, photo(p, "hsv"), cfg), m),
                   1e-3)]
        x, m = ops.dihedral_normalize(images.cuda(), flags.cuda(), masks.cuda())
        errors = {}
        for stage, fn, tol in stages:
            kept = torch.ones(2, dtype=torch.bool)
            if stage == "colour":
                tie, errors["clahe_levels_off_at_ties"] = check_clahe_card_vs_cpu(
                    augment, x, card.photometric.color.clahe_clip, cfg.clahe_tiles)
                kept &= ~(tie & (host.photometric.color.choice < 0.25))
            ref_x, ref_m = fn(x.cpu(), m.cpu(), host)
            x, m = fn(x, m, card)
            err = (x.cpu() - ref_x)[kept].abs().max().item() if kept.any() else 0.0
            off = (m.cpu() != ref_m).float().mean().item()
            errors[stage] = {"max_abs_err": err, "mask_share_off": off,
                             "images_compared": int(kept.sum())}
            if not (err <= tol and off <= 1e-4):
                raise AssertionError(f"{name} {stage} on the card vs the CPU: {errors[stage]}")
        result[name] = errors
    print(json.dumps({"augment_card_vs_cpu": result}), flush=True)
    return result


def check_fused_ce(ops, gen, dtype):
    """fused_cross_entropy forward and backward vs the plain versions at the
    train step's shape.  Tolerance: loss 1e-5 relative; dlogits 1e-5 of the
    largest entry in float32, one bfloat16 ulp (2^-7 of it) in bfloat16."""
    shape = (TRAIN_BATCH, TILE, TILE, CLASSES)
    logits = (3 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    labels = torch.randint(0, CLASSES, shape[:-1], generator=gen, device="cuda",
                           dtype=torch.int32)
    x = logits.clone().requires_grad_()
    loss = ops.fused_cross_entropy(x, labels)
    loss.backward()
    torch.cuda.synchronize()
    ref = ops.fused_cross_entropy_reference(logits, labels)
    g_ref = ops.fused_cross_entropy_grad_reference(logits, labels,
                                                   torch.ones((), device="cuda"))
    torch.testing.assert_close(loss.detach(), ref, rtol=1e-5, atol=1e-5)
    peak = g_ref.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    grad_err = (x.grad.float() - g_ref.float()).abs().max().item()
    if not grad_err <= tol * peak:
        raise AssertionError(f"dlogits off by {grad_err} (largest entry {peak}) in {dtype}")
    del g_ref

    def fwd_bwd(loss_fn):
        x.grad = None
        loss_fn(x).backward()

    n, elt = logits.numel(), logits.element_size()
    rows = n // CLASSES
    flat_labels = labels.reshape(-1).long()
    library = lambda t: F.cross_entropy(t.reshape(-1, CLASSES), flat_labels)
    res = dict(kernel="fused_cross_entropy", shape=list(shape), dtype=dtype_name(dtype),
               tolerance="loss 1e-5, dlogits 1e-5 (f32) / 2^-7 (bf16) of the largest entry",
               max_abs_err=abs(loss.item() - ref.item()), grad_max_abs_err=grad_err,
               fwd_ms=time_ms(lambda: ops.fused_cross_entropy(logits, labels)),
               fwd_bwd_ms=time_ms(lambda: fwd_bwd(lambda t: ops.fused_cross_entropy(t, labels))),
               plain_fwd_bwd_ms=time_ms(lambda: (
                   ops.fused_cross_entropy_reference(logits, labels),
                   ops.fused_cross_entropy_grad_reference(logits, labels, loss.detach()))),
               library_fwd_ms=time_ms(lambda: library(logits)),
               library_fwd_bwd_ms=time_ms(lambda: fwd_bwd(library)))
    # forward: logits and labels read once; backward: read again, dlogits written
    res["bound_ms"], res["bound_by"] = roofline(3 * n * elt + 8 * rows + 8, 30 * n)
    print("kernel check", json.dumps(res), flush=True)
    return res


def dihedral_only(augment):
    """The weak pipeline with every stage after the dihedral one switched off."""
    return dataclasses.replace(augment.WEAK, p_ssr=0.0, p_distort=0.0, p_noise=0.0,
                               p_blur=0.0, p_color=0.0, p_hsv=0.0)


def train_batches(host_rng, n, batch=TRAIN_BATCH, tile=TILE):
    return [(host_rng.integers(0, 256, (batch, tile, tile, 3), dtype=np.uint8),
             host_rng.integers(0, CLASSES, (batch, tile, tile), dtype=np.uint8))
            for _ in range(n)]


def kernel_counters():
    """name -> the wrapper function carrying that kernel's ``launches`` count."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        channel_sums,
        conv_bn_relu,
        dihedral,
        fused_ce,
    )

    return {"conv_bn_relu": conv_bn_relu.conv_bn_relu,
            "channel_sums": channel_sums.channel_sums,
            "channel_dual_sums": channel_sums.channel_dual_sums,
            "dihedral_normalize": dihedral.dihedral_normalize,
            "fused_cross_entropy": fused_ce.fused_cross_entropy}


def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def probe_batch(batch: int) -> int:
    """Does a bf16 train step of the full-width model fit at ``batch``?
    Prints one JSON line with the answer, the peak memory and the step time."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import augment
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_supervised_train_step,
    )

    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda")
    state = TrainState(model, adam(1e-4))
    step = make_supervised_train_step(model, CLASSES, fused_ce=True)          # WEAK
    images, masks = (torch.from_numpy(a).cuda() for a in
                     train_batches(np.random.default_rng(SEED), 1, batch)[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"batch": batch, "tile": TILE, "dtype": "bfloat16", "card": card_line()}
    torch.cuda.reset_peak_memory_stats()
    try:
        step(state, gen, images, masks)
        torch.cuda.synchronize()
        result["step_ms"] = time_ms(lambda: step(state, gen, images, masks), reps=3, warmup=0)
        result["fits"] = True
    except torch.cuda.OutOfMemoryError as e:
        result["fits"] = False
        result["error"] = str(e).splitlines()[0][:200]
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"probe": result}), flush=True)
    return 0


# the trainer phase: an in-memory dataset of seeded 512 px tiles, split 64 / 16
TRAINER_TILES, TRAINER_TRAIN, TRAINER_EPOCHS = 80, 64, 2
# what the JAX trainer writes as scalars (train / validate / early stopping)
TRAINER_SCALAR_TAGS = (
    ["train/loss", "train/iou", "train/accuracy", "train/learning_rate",
     "perf/steps_per_sec", "perf/tiles_per_sec", "perf/step_ms_p50",
     "val/loss", "val/iou", "val/accuracy", "val/iou_epoch",
     "early_stopping/score", "early_stopping/counter"]
    + [f"train/iou_class_{c}" for c in range(CLASSES)])
TRAINER_IMAGE_TAGS = [f"{p}/{k}" for p in ("train", "val")
                      for k in ("image", "ground_truth", "prediction", "overlay",
                                "confusion_matrix", "roc_curves", "pr_curves")]
# installation facts printed with the trainer line: the modules the JAX
# trainer path imports, and the toolchain the native decoder needs
INSTALL_MODULES = ("cv2", "PIL", "pandas", "tqdm", "matplotlib", "seaborn", "sklearn",
                   "tensorboard", "triton", "jax")
INSTALL_FILES = ("/usr/include/jpeglib.h", "/usr/include/png.h")


class InMemoryTiles:
    """Seeded uint8 tiles and int32 masks in host memory, with the
    ``load_raw`` contract of ``DroneDataset`` (the card's machine has no
    image decoder; file decoding is held against the JAX package on the
    CPU, in tests/test_torch_data.py)."""

    def __init__(self, images, masks):
        self.images, self.masks = images, masks

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx):
        return self.images[idx], self.masks[idx]

    __getitem__ = load_raw


def installation() -> dict:
    """Which of the JAX trainer path's imports and of the native decoder's
    toolchain this machine has, and whether the native decoder builds."""
    import importlib.util
    import shutil

    from uda_aerial_semantic_segmentation_research_tpu_torch.data import native

    return {"modules": {m: importlib.util.find_spec(m) is not None for m in INSTALL_MODULES},
            "g++": shutil.which("g++") is not None,
            "headers": {f: os.path.exists(f) for f in INSTALL_FILES},
            "native_decoder_builds": native.available()}


def trace_events(prof):
    """The device events of a profile as dicts (name, cat, stream, ts, dur,
    bytes), read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            args = e.get("args", {})
            out.append({"name": e["name"], "cat": e["cat"], "stream": args.get("stream"),
                        "ts": float(e["ts"]), "dur": float(e["dur"]),
                        "bytes": args.get("bytes")})
    return out


def union_us(spans) -> float:
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (cur[1] - cur[0] if cur else 0.0)


def overlap_us(span, spans) -> float:
    """Time of ``span`` covered by the union of ``spans``."""
    start, end = span
    return union_us([(max(s, start), min(e, end)) for s, e in spans
                     if e > start and s < end])


def drive_trainer(counters, card, host_rng) -> dict:
    """Phase 9: ``SegmentationTrainer.train`` on the card (see main)."""
    import warnings

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        WeightedRandomSampler,
        class_balance,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_model,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import train as train_mod
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
        read_events,
    )

    install = installation()
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    dataset = InMemoryTiles(images, masks)
    counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
    _, weights = class_balance([{c: int(n[c]) for c in np.nonzero(n)[0]} for n in counts],
                               [m.size for m in masks])
    train_ds, val_ds = random_split(dataset, [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                    seed=SEED)
    w = weights[train_ds.indices]
    sampler = WeightedRandomSampler(w / w.sum(), num_samples=len(w))
    train_loader = DataLoader(train_ds, batch_size=TRAIN_BATCH, sampler=sampler,
                              num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=TRAIN_BATCH)
    steps_per_epoch = len(train_loader)

    model = create_model("Unet", "resnet34", encoder_weights=None, classes=CLASSES,
                         seed=SEED, dtype=torch.bfloat16, device="cuda")
    probe = torch.from_numpy(images[-2:]).cuda()          # two validation tiles

    class EarlyStoppingFromEpochOne(train_mod.EarlyStopping):
        """The trainer's early stopper, with min_epochs=1 so that a 2-epoch
        run selects and saves a best model (the trainer keeps 10)."""

        def __init__(self, **kw):
            super().__init__(**{**kw, "min_epochs": 1})

    saved, per_step, batch_kinds, figure_ms, val_ms, epoch_times = [], [], [], [], [], []
    record = {}
    real_save, real_early = train_mod.save_checkpoint, train_mod.EarlyStopping
    with tempfile.TemporaryDirectory() as tmp:
        old_dirs = Config.LOGS_DIR, Config.CHECKPOINTS_DIR
        Config.LOGS_DIR, Config.CHECKPOINTS_DIR = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        trainer = train_mod.SegmentationTrainer(model, device="cuda")

        def save_and_snapshot(obj, path):
            t0 = time.perf_counter()
            real_save(obj, path)
            write_ms = (time.perf_counter() - t0) * 1e3
            saved.append({"path": str(path), "epoch": obj["epoch"], "write_ms": write_ms,
                          "bytes": os.path.getsize(path),
                          "logits": make_predict_step(trainer.model)(probe).clone()})

        trainer._build_steps()
        train_step, log_figures = trainer._train_step, trainer._log_figures
        validate, train_epoch = trainer.validate, trainer.train_epoch

        def counted_step(state, gen, imgs, msks):
            before = read_counts(counters)
            out = train_step(state, gen, imgs, msks)
            after = read_counts(counters)
            per_step.append({k: after[k] - before[k] for k in after})
            batch_kinds.append({"images": str(imgs.dtype), "masks": str(msks.dtype),
                                "on_card": imgs.is_cuda and msks.is_cuda})
            return out

        def timed_figures(*args, **kw):
            caught = record.get("caught")                  # the observed epoch's
            n0, t0 = len(caught or ()), time.perf_counter()
            log_figures(*args, **kw)          # ends on host copies: nothing left queued
            figure_ms.append((time.perf_counter() - t0) * 1e3)
            if caught is not None:
                record["figure_syncs"].update(range(n0, len(caught)))

        def timed_validate(loader):
            t0 = time.perf_counter()
            out = validate(loader)
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def observed_epoch(loader, state, epoch):
            if epoch != TRAINER_EPOCHS:
                out = train_epoch(loader, state, epoch)
                epoch_times.extend(trainer.timer.times)
                return out
            # the last epoch: its device trace and its host syncs
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                record["caught"], record["figure_syncs"] = caught, set()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = train_epoch(loader, state, epoch)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
            epoch_times.extend(trainer.timer.times)
            del record["caught"]
            syncs = [i for i, w in enumerate(caught) if "called a synchronizing" in str(w.message)]
            in_figures = record["figure_syncs"]
            record["syncs"] = len(syncs)
            record["figure_syncs"] = len(in_figures.intersection(syncs))
            record["sync_sites"] = collections.Counter(
                f"{pathlib.Path(caught[i].filename).name}:{caught[i].lineno}" for i in syncs
                if i not in in_figures)
            record["events"], record["wall_us"] = trace_events(prof), wall_us
            return out

        trainer._train_step, trainer._log_figures = counted_step, timed_figures
        trainer.validate, trainer.train_epoch = timed_validate, observed_epoch
        train_mod.save_checkpoint = save_and_snapshot
        train_mod.EarlyStopping = EarlyStoppingFromEpochOne
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts(counters)
            best = trainer.train(train_loader, val_loader, epochs=TRAINER_EPOCHS,
                                 learning_rate=1e-4)
            torch.cuda.synchronize()
            run_counts = read_counts(counters)
        finally:
            train_mod.save_checkpoint, train_mod.EarlyStopping = real_save, real_early
            Config.LOGS_DIR, Config.CHECKPOINTS_DIR = old_dirs
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        n_steps = TRAINER_EPOCHS * steps_per_epoch
        expected = {"conv_bn_relu": 0, "channel_sums": 46, "channel_dual_sums": 46,
                    "dihedral_normalize": 1, "fused_cross_entropy": 0}
        print(f"main path (trainer): {TRAINER_EPOCHS} epochs, {n_steps} steps, launches "
              f"{json.dumps(run_counts)}", flush=True)
        if len(per_step) != n_steps or any(c != expected for c in per_step):
            raise AssertionError(f"trainer launches per step {per_step}, expected {expected}")
        if run_counts != {k: v * n_steps for k, v in expected.items()}:
            raise AssertionError(f"kernel launches outside the train steps: {run_counts}")
        if any(b != {"images": "torch.uint8", "masks": "torch.uint8", "on_card": True}
               for b in batch_kinds):
            raise AssertionError(f"prefetched batches {batch_kinds}")
        if not best or not saved:
            raise AssertionError("the trainer selected or saved no best model")

        # the best checkpoint: JAX layout, back through from_jax_state_dict
        ckpt = load_checkpoint(saved[-1]["path"])
        if set(ckpt) != {"epoch", "model_state_dict", "optimizer_state_dict", "metrics",
                         "improvement_rates"} or ckpt["epoch"] != saved[-1]["epoch"]:
            raise AssertionError(f"best checkpoint holds {sorted(ckpt)}")
        reloaded = create_model("Unet", "resnet34", encoder_weights=None, classes=CLASSES,
                                seed=SEED + 1, dtype=torch.bfloat16, device="cuda")
        reloaded.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
        if not torch.equal(make_predict_step(reloaded)(probe), saved[-1]["logits"]):
            raise AssertionError("logits of the reloaded best checkpoint differ")
        del reloaded, ckpt

        # the event file: every record's CRCs, the JAX trainer's tags
        event_files = list(pathlib.Path(tmp, "logs").rglob("events.out.tfevents.*"))
        if len(event_files) != 1:
            raise AssertionError(f"event files {event_files}")
        tb_events = read_events(event_files[0])
        found = {(v["tag"], v["kind"]) for e in tb_events for v in e["values"]}
        missing = ([t for t in TRAINER_SCALAR_TAGS if (t, "scalar") not in found]
                   + [t for t in TRAINER_IMAGE_TAGS if (t, "image") not in found])
        if missing:
            raise AssertionError(f"tags missing from the event file: {missing}")

    # the last epoch's trace: H2D copies (pinned, on their own stream,
    # overlapped with the compute stream's kernels) and the busy share
    events = record["events"]
    kernels = [e for e in events if e["cat"] == "kernel"]
    compute_streams = collections.Counter(e["stream"] for e in kernels)
    compute_stream = compute_streams.most_common(1)[0][0]
    batch_bytes = TRAIN_BATCH * TILE * TILE * 4             # images + uint8 masks
    h2d = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
           and (e["bytes"] or 0) >= TRAIN_BATCH * TILE * TILE]
    h2d_bytes = sum(e["bytes"] for e in h2d)
    if h2d_bytes != steps_per_epoch * batch_bytes:
        raise AssertionError(f"H2D copies of the training batches: {h2d_bytes} bytes, "
                             f"expected {steps_per_epoch * batch_bytes}")
    if not all("Pinned" in e["name"] and e["stream"] != compute_stream for e in h2d):
        raise AssertionError(f"H2D copies not pinned or on the compute stream: "
                             f"{[(e['name'], e['stream']) for e in h2d]}")
    compute_spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels
                     if e["stream"] == compute_stream]
    h2d_us = sum(e["dur"] for e in h2d)
    covered_us = sum(overlap_us((e["ts"], e["ts"] + e["dur"]), compute_spans) for e in h2d)
    busy_us = union_us([(e["ts"], e["ts"] + e["dur"]) for e in events])
    step_times = np.asarray(epoch_times) * 1e3

    # the bare train step (the trainer's: WEAK, plain CE), batches on the card
    dev = [tuple(torch.from_numpy(a).cuda() for a in (images[i:i + TRAIN_BATCH],
                                                       masks[i:i + TRAIN_BATCH].astype(np.uint8)))
           for i in (0, TRAIN_BATCH)]
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )

    state = TrainState(trainer.model, adam(1e-4))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    turn = iter(range(10 ** 9))
    bare_ms = time_ms(lambda: train_step(state, gen, *dev[next(turn) % 2]), reps=5, warmup=1)
    result = {
        "model": "resnet34 U-Net, 23 classes", "dtype": "bfloat16", "batch": TRAIN_BATCH,
        "tile": TILE, "augmentation": "WEAK (the trainer's default)", "fused_ce": False,
        "epochs": TRAINER_EPOCHS, "train_steps": n_steps, "validations": len(val_ms),
        "launches_per_step": per_step[0], "launches": run_counts,
        "step_timer_ms_p50": float(np.percentile(step_times, 50)),
        "step_timer_ms_p95": float(np.percentile(step_times, 95)),
        "step_timer_steps": len(step_times),
        "tiles_per_s": TRAIN_BATCH / float(np.mean(step_times)) * 1e3,
        "bare_step_ms": bare_ms, "bare_tiles_per_s": TRAIN_BATCH / bare_ms * 1e3,
        "h2d_ms_per_batch": h2d_us / 1e3 / steps_per_epoch,
        "h2d_bytes_per_batch": batch_bytes, "h2d_pinned": True,
        "h2d_overlapped_share": covered_us / h2d_us if h2d_us else "not measured",
        "h2d_streams": sorted({e["stream"] for e in h2d}), "compute_stream": compute_stream,
        "device_busy_share_epoch": busy_us / record["wall_us"],
        "epoch_wall_ms": record["wall_us"] / 1e3,
        "validation_ms": val_ms, "figure_logging_host_ms": figure_ms,
        "checkpoint_bytes": saved[-1]["bytes"],
        "checkpoint_write_ms": [s["write_ms"] for s in saved],
        "best_epoch": saved[-1]["epoch"],
        "host_syncs_last_epoch": record["syncs"],
        "host_syncs_in_figure_logging": record["figure_syncs"],
        "host_syncs_per_train_step": (record["syncs"] - record["figure_syncs"])
        / steps_per_epoch,
        "host_sync_sites_outside_figures": dict(record["sync_sites"]),
        "peak_mem_gib": peak_gib, "event_records": len(tb_events),
        "installation": install, "card": card}
    del trainer, model, state, dev, train_step
    torch.cuda.empty_cache()
    return result


def _trainer_child(card) -> dict:
    return drive_trainer(kernel_counters(), card, np.random.default_rng(SEED + 9))


def trainer_phase(card) -> dict:
    """Phase 9 in a fresh process (spawned, one card, kernels loaded from the
    libraries this process built): in a process that has taken many
    profiler windows, a later trace lost events on the H100 -- the trainer's
    H2D copies after phase 3b's windows, and one sums kernel in 20 of every
    3b window after the trainer's profiled epoch."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_trainer_child, (card,))


# the pipeline phase: run_pipeline over in-memory source tiles (80, split
# 64 / 16) and target tiles (64, another photometric offset), one epoch a
# phase at B=32: 2 steps in each phase
PIPE_TARGETS, PIPE_DEVICE, PIPE_ENCODER = 64, "cuda", "resnet34"
# the discriminator's BatchNorm inputs at 512 px, B=32 (NHWC)
DISC_BN_SHAPES = [(32, 128, 128, 128), (32, 64, 64, 256), (32, 32, 32, 512)]
# the train step each phase of the pipeline builds on the card: phase 3 is the
# trainer's production path, the sequential step
STEP_FACTORIES = ("make_supervised_train_step", "make_adversarial_train_step",
                  "make_unsupervised_sequential_step")


class InMemoryTargets:
    """Seeded uint8 target tiles with ``TargetDataset``'s ``load_raw``."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx):
        return self.images[idx]

    __getitem__ = load_raw


def encoder_block_bns(model) -> int:
    """The BatchNorms inside the U-Net encoder's residual blocks: what
    encoder remat recomputes in each grad-bearing pass."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm

    return sum(isinstance(m, BatchNorm) for name, block in model.encoder.named_children()
               if name.startswith("stage") for m in block.modules())


def pipeline_expected_launches(n_unet_bn: int, n_disc_bn: int, n_block_bn: int) -> dict:
    """Kernel launches per train step of each step factory: one
    ``channel_sums`` per train-mode BatchNorm forward (a recompute's
    included) and one ``channel_dual_sums`` per BatchNorm backward, one
    ``dihedral_normalize`` per augmented batch (eval-mode BatchNorm and the
    discriminator's eval forward in phase 2's G-step launch nothing)."""
    def counts(fwd, bwd, dihedral):
        return {"conv_bn_relu": 0, "channel_sums": fwd, "channel_dual_sums": bwd,
                "dihedral_normalize": dihedral, "fused_cross_entropy": 0}
    return {"make_supervised_train_step": counts(n_unet_bn, n_unet_bn, 1),
            # U-Net on the source batch; D on the source and on the target batch
            "make_adversarial_train_step": counts(n_unet_bn + 2 * n_disc_bn,
                                                  n_unet_bn + 2 * n_disc_bn, 2),
            # U-Net on two target views; D on the un-augmented target batch
            "make_unsupervised_train_step": counts(2 * n_unet_bn + n_disc_bn,
                                                   2 * n_unet_bn + n_disc_bn, 2),
            # D; the U-Net on view 1 without gradients, then on view 2 and view 1
            # with them
            "sequential, no remat": counts(3 * n_unet_bn + n_disc_bn,
                                           2 * n_unet_bn + n_disc_bn, 2),
            # as the trainer runs it on the card: encoder remat recomputes the
            # block BatchNorms of both grad-bearing passes
            "make_unsupervised_sequential_step": counts(
                3 * n_unet_bn + 2 * n_block_bn + n_disc_bn, 2 * n_unet_bn + n_disc_bn, 2)}


def f32_draws(augment, host_rng, batch, tile):
    """A seeded uint8 batch and float32 WEAK's draws for it, made once on the
    host: a CUDA and a CPU generator draw different numbers."""
    small = train_batches(host_rng, 1, batch=batch, tile=tile)[0]
    cfg32 = dataclasses.replace(augment.WEAK, compute_dtype="float32")
    host_gen = torch.Generator().manual_seed(SEED)
    abc = augment._sample_dihedral(host_gen, batch, cfg32)
    params = augment.sample_params(host_gen, small[0].shape, cfg32, has_masks=True)
    if not any(d.do.any() for d in (*params.warp, *params.photometric) if d is not None):
        raise AssertionError("the f32 step's draws select no augmentation stage")
    return small, cfg32, abc, params


def f32_step_card_vs_cpu(label, cpu_model, draws, counters, head, fused_ce=False) -> dict:
    """One float32 train step of ``make_supervised_train_step`` on the card
    (kernels) against the same step on ``cpu_model`` (plain versions), same
    weights and draws.  Tolerances: loss 1e-4 relative; hist may differ by
    0.1% of the pixels (argmax of near-ties); all gradients together 5e-2
    relative in L2 and the ``head`` kernel 1e-3 of its largest entry --
    through the whole network single ReLU units flip under float32 noise
    (tests/test_torch_train_step.py)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_supervised_train_step,
    )

    small, cfg32, abc, params = draws
    runs = {}
    for where in ("card", "cpu"):
        m32 = copy.deepcopy(cpu_model).to(PIPE_DEVICE) if where == "card" else cpu_model
        reset_counts(counters)
        _, met = make_supervised_train_step(m32, CLASSES, aug_cfg=cfg32, fused_ce=fused_ce)(
            TrainState(m32, adam(1e-4)), None, *small, abc=abc, params=params)
        torch.cuda.synchronize()
        if (sum(read_counts(counters).values()) > 0) != (where == "card"):
            raise AssertionError(f"{label}: kernel launches on the {where}: "
                                 f"{read_counts(counters)}")
        runs[where] = (met["loss"].item(), met["hist"].cpu(),
                       {k: p.grad.detach().cpu() for k, p in m32.named_parameters()
                        if p.grad is not None})
        del m32
    (loss_gpu, hist_gpu, g_gpu), (loss_cpu, hist_cpu, g_cpu) = runs["card"], runs["cpu"]
    if set(g_gpu) != set(g_cpu):
        raise AssertionError(f"{label}: the parameters with a gradient differ")
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in sorted(g)])  # noqa: E731
    grad_rel_l2 = ((flat(g_gpu) - flat(g_cpu)).norm() / flat(g_cpu).norm()).item()
    head_err = ((g_gpu[head] - g_cpu[head]).abs().max() / g_cpu[head].abs().max()).item()
    hist_l1 = (hist_gpu - hist_cpu).abs().sum().item()
    res = {"loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "hist_l1_diff": hist_l1,
           "grad_rel_l2": grad_rel_l2, "head_kernel_grad_max_rel_err": head_err}
    if (abs(loss_gpu - loss_cpu) > 1e-4 * abs(loss_cpu) or grad_rel_l2 > 5e-2
            or head_err > 1e-3 or hist_l1 > 2 * 0.001 * small[1].size):
        raise AssertionError(f"{label}: float32 train step on the card disagrees with the "
                             f"CPU: {res}")
    return res


def bits(t):
    """A tensor's bits, so that NaN compares equal to the same NaN."""
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def state_snapshot(state) -> dict:
    """Every element of a phase-3 state: parameters, BatchNorm buffers, Adam
    moments and counts, the step counter (clones)."""
    snap = {f"model/{k}": bits(v).clone() for k, v in
            itertools.chain(state.model.named_parameters(), state.model.named_buffers())}
    names = {id(p): k for k, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            snap[f"adam/{names[id(p)]}/{k}"] = bits(v).clone()
    snap["step"] = state.step.clone()
    return snap


def counted(step, counters, record):
    """``step`` that appends the kernel launches of each call to ``record``."""
    def run(*a, **k):
        before = read_counts(counters)
        out = step(*a, **k)
        after = read_counts(counters)
        record.append({key: after[key] - before[key] for key in after})
        return out
    return run


def check_step_launches(label, per_step, expected, n_steps, run_counts):
    """``n_steps[name]`` steps in each phase (the length of the loader the
    phase iterates), exactly ``expected[name]`` launches in each, and none
    outside the steps; prints the census."""
    steps_run = {name: len(v) for name, v in per_step.items()}
    print(f"main path ({label}): steps {json.dumps(steps_run)}, launches "
          f"{json.dumps(run_counts)}", flush=True)
    for name, runs in per_step.items():
        if len(runs) != n_steps[name] or any(c != expected[name] for c in runs):
            raise AssertionError(f"{name} launches per step {runs}, expected {n_steps[name]} "
                                 f"steps of {expected[name]}")
    outside = {k: run_counts[k] - sum(c[k] for runs in per_step.values() for c in runs)
               for k in run_counts}
    if any(outside.values()):
        raise AssertionError(f"kernel launches outside the train steps: {outside}")
    return steps_run


def bare_step_report(fn, batches, turn) -> dict:
    """One bare train step ``fn(batch)`` on batches already on the card: p50 of
    5 steps after one warm-up (CUDA events), peak memory, host syncs per step
    under ``set_sync_debug_mode("warn")``, device ms by kind (profiler)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(batches[next(turn) % 2]), reps=5, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(2):
                fn(batches[next(turn) % 2])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    prof = profile_forward(lambda: fn(batches[next(turn) % 2]), reps=2)
    return {"bare_step_ms_p50": ms, "tiles_per_s": TRAIN_BATCH / ms * 1e3,
            "peak_mem_gib": peak_gib, "host_syncs_per_step": len(syncs) / 2,
            "host_sync_sites": sorted(set(syncs)), "device_ms": prof.get("device_ms_per_call"),
            "busy_share": prof.get("busy_share"), "by_category_ms": prof.get("by_category_ms")}


def drive_pipeline(counters, card, host_rng) -> dict:
    """Phase 10: ``run_pipeline`` on the card (see main)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        WeightedRandomSampler,
        class_balance,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        DomainAdaptationModel,
        create_discriminator,
        create_unet,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
        normalize_images,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
        ConsistencyLoss,
        FineTuningLoss,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        phase_manager as pm_mod,
        pipeline,
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        AdversarialState,
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    device = torch.device(PIPE_DEVICE)
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    targets = np.clip(host_rng.integers(0, 256, (PIPE_TARGETS, TILE, TILE, 3))
                      * 0.7 + 40.0, 0, 255).astype(np.uint8)
    source = InMemoryTiles(images, masks)
    counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
    _, weights = class_balance([{c: int(n[c]) for c in np.nonzero(n)[0]} for n in counts],
                               [m.size for m in masks])

    built = []

    def build_loaders(batch_size):
        """What ``_build_loaders`` builds from files, from the tiles above."""
        train_ds, val_ds = random_split(source, [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                        seed=Config.SEED)
        w = weights[train_ds.indices]
        sampler = WeightedRandomSampler(w / w.sum(), num_samples=len(w))
        built[:] = (DataLoader(train_ds, batch_size=batch_size, sampler=sampler, drop_last=True,
                               num_workers=Config.NUM_WORKERS),
                    DataLoader(val_ds, batch_size=batch_size),
                    DataLoader(InMemoryTargets(targets), batch_size=batch_size, shuffle=True,
                               drop_last=True, num_workers=Config.NUM_WORKERS))
        return tuple(built)

    model = create_unet(PIPE_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device=device)
    n_unet_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    n_disc_bn = sum(isinstance(m, BatchNorm) for m in
                    create_discriminator(device="cpu", dtype=torch.float32).modules())
    expected = pipeline_expected_launches(n_unet_bn, n_disc_bn, encoder_block_bns(model))
    probe = torch.from_numpy(images[-2:]).to(device)             # two validation tiles

    per_step = {name: [] for name in STEP_FACTORIES}
    real_factories = {name: getattr(step_lib, name) for name in STEP_FACTORIES}

    def counted_factory(name):
        return lambda *args, **kw: counted(real_factories[name](*args, **kw), counters,
                                           per_step[name])

    saved = []
    real_save = pm_mod.PhaseManager.save_checkpoint

    def save_and_snapshot(self, trainer, metrics, phase, is_best=False):
        """The phase checkpoint, timed, with the live models' logits on the
        probe tiles at that moment."""
        t0 = time.perf_counter()
        real_save(self, trainer, metrics, phase, is_best=is_best)
        write_ms = (time.perf_counter() - t0) * 1e3
        path = self.phase_dirs[phase] / ("best_model.pth" if is_best else "latest_model.pth")
        disc = getattr(trainer, "discriminator", None) if phase.name != "SEGMENTATION" else None
        entry = {"phase": phase.name, "path": str(path), "write_ms": write_ms,
                 "mb": os.path.getsize(path) / 1e6,
                 "logits": step_lib.make_predict_step(self.model)(probe).clone()}
        if disc is not None:
            disc.eval()
            with torch.inference_mode():
                entry["disc_logits"] = disc(normalize_images(probe), return_logits=True).clone()
            entry["disc_dtype"] = disc.dtype
        saved.append(entry)

    with tempfile.TemporaryDirectory() as tmp:
        old = (Config.LOGS_DIR, Config.CHECKPOINTS_DIR, Config.DEVICE, Config.ENCODER_WEIGHTS,
               pipeline._build_loaders)
        Config.LOGS_DIR, Config.CHECKPOINTS_DIR = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
        Config.DEVICE, Config.ENCODER_WEIGHTS = PIPE_DEVICE, None
        pipeline._build_loaders = build_loaders
        pm_mod.PhaseManager.save_checkpoint = save_and_snapshot
        for name in STEP_FACTORIES:
            setattr(step_lib, name, counted_factory(name))
        try:
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            summary = pipeline.run_pipeline(phase1_epochs=1, phase2_epochs=1, phase3_epochs=1,
                                            batch_size=TRAIN_BATCH, force_transitions=True,
                                            checkpoints_dir=os.path.join(tmp, "ckpt"),
                                            model=model)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            run_counts = read_counts(counters)
        finally:
            (Config.LOGS_DIR, Config.CHECKPOINTS_DIR, Config.DEVICE, Config.ENCODER_WEIGHTS,
             pipeline._build_loaders) = old
            pm_mod.PhaseManager.save_checkpoint = real_save
            for name, fn in real_factories.items():
                setattr(step_lib, name, fn)

        # phases 1 and 2 iterate the source train loader, phase 3 the target one
        n_steps = dict(zip(STEP_FACTORIES, (len(built[0]), len(built[0]), len(built[2]))))
        steps_run = check_step_launches("pipeline", per_step, expected, n_steps, run_counts)

        # the summary and the experiment's metadata
        if set(summary["phases"]) != {"segmentation", "adversarial", "fine_tuning"} \
                or summary.get("final_phase") != "FINE_TUNING":
            raise AssertionError(f"pipeline summary {summary}")
        with open(pathlib.Path(summary["experiment_dir"]) / "training_metadata.json") as f:
            metadata = json.load(f)
        phases = ["SEGMENTATION", "ADVERSARIAL", "FINE_TUNING"]
        if (sorted(metadata["best_metrics"]) != sorted(phases)
                or metadata["phases_completed"] != phases[:2]
                or metadata["current_phase"] != phases[2]
                or [(t["from_phase"], t["to_phase"]) for t in metadata["phase_transitions"]]
                != list(zip(phases, phases[1:]))):
            raise AssertionError(f"training_metadata.json {metadata}")

        # every phase's best checkpoint reloads bit for bit
        if [s["phase"] for s in saved] != phases:
            raise AssertionError(f"phase checkpoints {[s['phase'] for s in saved]}")
        for s in saved:
            ckpt = load_checkpoint(s["path"])
            has_disc = "discriminator_state_dict" in ckpt
            if has_disc != (s["phase"] != "SEGMENTATION"):
                raise AssertionError(f"{s['phase']} checkpoint holds {sorted(ckpt)}")
            unet = create_unet(PIPE_ENCODER, classes=CLASSES, seed=SEED + 1,
                               dtype=torch.bfloat16, device=device)
            unet.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
            if not torch.equal(step_lib.make_predict_step(unet)(probe), s["logits"]):
                raise AssertionError(f"{s['phase']}: the reloaded U-Net's logits differ")
            if has_disc:
                disc = create_discriminator(seed=SEED + 2, dtype=s["disc_dtype"], device=device)
                disc.load_state_dict(from_jax_state_dict(ckpt["discriminator_state_dict"]),
                                     strict=True)
                with torch.inference_mode():
                    got = disc(normalize_images(probe), return_logits=True)
                if not torch.equal(got, s["disc_logits"]):
                    raise AssertionError(f"{s['phase']}: the reloaded discriminator differs")
            del unet, ckpt
        # the final discriminator (phase 3's), for the bare steps below
        disc = create_discriminator(seed=SEED, dtype=saved[-1]["disc_dtype"], device=device)
        disc.load_state_dict(from_jax_state_dict(load_checkpoint(saved[-1]["path"])[
            "discriminator_state_dict"]), strict=True)

    # the bare step of each phase on the final models (bare_step_report)
    dev = [tuple(torch.from_numpy(a).to(device) for a in (
        images[i:i + TRAIN_BATCH], masks[i:i + TRAIN_BATCH].astype(np.uint8),
        targets[i:i + TRAIN_BATCH])) for i in (0, TRAIN_BATCH)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    # the census of the discriminator's BatchNorm inputs (the shapes 3b checks)
    disc_bn_shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: disc_bn_shapes.append(tuple(inp[0].permute(0, 2, 3, 1).shape)))
        for m in disc.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        disc(normalize_images(dev[0][2]), return_logits=True)
    for h in hooks:
        h.remove()
    if disc_bn_shapes != [(TRAIN_BATCH, *s[1:]) for s in DISC_BN_SHAPES]:
        raise AssertionError(f"discriminator BatchNorm inputs {disc_bn_shapes}")
    turn = itertools.count()
    sup_state = TrainState(model, adam(1e-4))
    adv_state = AdversarialState(TrainState(model, adam(1e-4)), TrainState(disc, adam(1e-4)))
    unsup_state = TrainState(DomainAdaptationModel(model, disc), adam(1e-5, clip_norm=1.0),
                             skip_nonfinite=True)
    sup = step_lib.make_supervised_train_step(model, CLASSES)
    adv = step_lib.make_adversarial_train_step(model, disc, CLASSES)
    # phase 3 as UnsupervisedTrainer runs it on the card
    unsup = step_lib.make_unsupervised_sequential_step(
        model.clone(remat="encoder", logits_dtype=torch.bfloat16), disc, CLASSES,
        FineTuningLoss(), carry_dtype=torch.bfloat16)
    bare = {
        "make_supervised_train_step": lambda b: sup(sup_state, gen, b[0], b[1]),
        "make_adversarial_train_step": lambda b: adv(adv_state, gen, b[0], b[1], b[2]),
        "make_unsupervised_sequential_step": lambda b: unsup(unsup_state, gen, b[2], 1.0)}
    phase_of = dict(zip(STEP_FACTORIES, ("phase1", "phase2", "phase3")))
    per_phase = {phase_of[name]: bare_step_report(fn, dev, turn)
                 | {"launches_per_step": per_step[name][0]} for name, fn in bare.items()}

    # phase 3's consistency KL alone, forward and backward at the step's
    # logits shape: chunked (as the step runs it) and whole; its byte bound
    # reads both float32 logits and writes both gradients once
    z = [torch.randn((TRAIN_BATCH, TILE, TILE, CLASSES), device=device,
                     generator=torch.Generator(device=device).manual_seed(SEED + i),
                     requires_grad=True) for i in range(2)]
    kl = {}
    for label, fn in (("chunked", step_lib.chunked_consistency(ConsistencyLoss())),
                      ("whole", ConsistencyLoss())):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kl[f"{label}_ms"] = time_ms(lambda: fn(*z).backward(), reps=5, warmup=1)
        kl[f"{label}_peak_added_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kl["bound_ms"], kl["bound_by"] = roofline(4 * z[0].numel() * 4, 0)
    kl["shape"] = list(z[0].shape)
    del z

    # the non-finite guard: one phase-3 step with a NaN in D's classifier bias
    bias = disc.classifier.bias
    with torch.no_grad():
        bias.fill_(float("nan"))
    before = state_snapshot(unsup_state)
    _, nan_metrics = unsup(unsup_state, gen, dev[0][2], 1.0)
    torch.cuda.synchronize()
    after = state_snapshot(unsup_state)
    if nan_metrics["finite"].item() or set(before) != set(after):
        raise AssertionError("the NaN step reported a finite loss")
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    if moved:
        raise AssertionError(f"the NaN step changed the state: {moved[:5]}")

    for s in saved:
        s.pop("logits")
        s.pop("disc_logits", None)
        s.pop("disc_dtype", None)
    result = {
        "model": f"{PIPE_ENCODER} U-Net, {CLASSES} classes, + DomainDiscriminator",
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "tile": TILE,
        "data": f"{TRAINER_TILES} source tiles (split {TRAINER_TRAIN} / "
                f"{TRAINER_TILES - TRAINER_TRAIN}), {PIPE_TARGETS} target tiles, in memory",
        "epochs_per_phase": 1, "steps": steps_run,
        "phase3_remat": "encoder",
        "phase3_step": "sequential, bf16 logits and carry (the trainer's resolution)",
        "phases": per_phase, "consistency_kl": kl, "launches": run_counts,
        "checkpoints": [{k: s[k] for k in ("phase", "mb", "write_ms")} for s in saved],
        "pipeline_wall_s": wall_s,
        "nan_step_state_bit_identical": True,
        "summary_phases": sorted(summary["phases"]), "card": card}
    del model, disc, sup_state, adv_state, unsup_state, dev
    torch.cuda.empty_cache()
    return result


def _pipeline_child(card) -> dict:
    return drive_pipeline(kernel_counters(), card, np.random.default_rng(SEED + 10))


def pipeline_phase(card) -> dict:
    """Phase 10 in a fresh process of its own (spawned, as phase 9)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_pipeline_child, (card,))


# the multi-phase phase: MultiPhaseTrainer over the GRL model at its default
# width (resnet50 U-Net + feature discriminator), one epoch a phase at B=32
# over the in-memory tiles of phase 10: 2 steps in each phase
MULTI_ENCODER = "resnet50"
# the BatchNorm inputs of the resnet50 U-Net (NHWC shape: BatchNorms, encoder
# and decoder) and of the feature discriminator at 512 px, B=32
UDA_UNET_BN_SHAPES = {
    (32, 256, 256, 64): 1, (32, 128, 128, 64): 8, (32, 128, 128, 256): 4,
    (32, 128, 128, 128): 1, (32, 64, 64, 128): 9, (32, 64, 64, 512): 5,
    (32, 64, 64, 256): 1, (32, 32, 32, 256): 13, (32, 32, 32, 1024): 7,
    (32, 32, 32, 512): 1, (32, 16, 16, 512): 5, (32, 16, 16, 2048): 4,
    (32, 256, 256, 32): 2, (32, 512, 512, 16): 2}
UDA_HEAD_BN_SHAPES = [(32, 16, 16, 512), (32, 16, 16, 256), (32, 16, 16, 128)]
MULTI_PHASES = ("phase1", "phase2", "phase3")


def multiphase_expected_launches(n_encoder_bn: int, n_decoder_bn: int, n_head_bn: int) -> dict:
    """Kernel launches per train step of each phase of ``MultiPhaseTrainer``:
    one ``channel_sums`` per train-mode BatchNorm forward, one
    ``channel_dual_sums`` per BatchNorm that the backward reaches, one
    ``dihedral_normalize`` per augmented batch (phase 3's ``x0`` is
    normalized without it)."""
    unet, head = n_encoder_bn + n_decoder_bn, n_head_bn

    def counts(forward, backward, dihedral):
        return {"conv_bn_relu": 0, "channel_sums": forward, "channel_dual_sums": backward,
                "dihedral_normalize": dihedral, "fused_cross_entropy": 0}
    return {
        # the U-Net on the source batch, dice
        "phase1": counts(unet, unet, 1),
        # source: U-Net + head; target: encoder + head (domain_only)
        "phase2": counts(unet + head + n_encoder_bn + head,
                         unet + head + n_encoder_bn + head, 2),
        # v1, v2: U-Net; x0: U-Net + head forward, its decoder gets no gradient
        "phase3": counts(3 * unet + head, 2 * unet + n_encoder_bn + head, 2)}


def drive_multiphase(counters, card, host_rng) -> dict:
    """Phase 11: ``MultiPhaseTrainer`` on the card (see main)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import random_split
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_uda_model,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
        normalize_images,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        MultiPhaseTrainer,
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    device = torch.device(PIPE_DEVICE)
    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    targets = np.clip(host_rng.integers(0, 256, (PIPE_TARGETS, TILE, TILE, 3))
                      * 0.7 + 40.0, 0, 255).astype(np.uint8)
    train_ds, val_ds = random_split(InMemoryTiles(images, masks),
                                    [TRAINER_TRAIN, TRAINER_TILES - TRAINER_TRAIN],
                                    seed=Config.SEED)
    train_loader = DataLoader(train_ds, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                              num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=TRAIN_BATCH)
    target_loader = DataLoader(InMemoryTargets(targets), batch_size=TRAIN_BATCH, shuffle=True,
                               drop_last=True, num_workers=Config.NUM_WORKERS)

    model = create_uda_model(MULTI_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                             device=device)
    n_bn = {part: sum(isinstance(m, BatchNorm) for m in module.modules()) for part, module in
            (("encoder", model.net.encoder), ("decoder", model.net.decoder),
             ("head", model.domain_discriminator))}
    expected = multiphase_expected_launches(n_bn["encoder"], n_bn["decoder"], n_bn["head"])
    probe = torch.from_numpy(images[-2:]).to(device)             # two validation tiles

    def outputs(m):
        """Eval-mode segmentation and domain logits of ``m`` on the probe tiles."""
        seg = step_lib.make_predict_step(m)(probe)
        with torch.inference_mode():
            d = m(normalize_images(probe), domain_adaptation=True, domain_only=True)[1]
        return seg.clone(), d.clone()

    # the BatchNorm input shapes of one traversal (eval mode: the same shapes
    # as a train-mode one, and no statistics move)
    unet_shapes, head_shapes = collections.Counter(), []
    nhwc = lambda inp: tuple(inp[0].permute(0, 2, 3, 1).shape)
    hooks = [m.register_forward_pre_hook(lambda mod, inp: unet_shapes.update([nhwc(inp)]))
             for m in model.net.modules() if isinstance(m, BatchNorm)]
    hooks += [m.register_forward_pre_hook(lambda mod, inp: head_shapes.append(nhwc(inp)))
              for m in model.domain_discriminator.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        model.eval()(normalize_images(torch.from_numpy(images[:TRAIN_BATCH]).to(device)),
                     domain_adaptation=True)
    for h in hooks:
        h.remove()
    if dict(unet_shapes) != UDA_UNET_BN_SHAPES or head_shapes != UDA_HEAD_BN_SHAPES:
        raise AssertionError(f"BatchNorm inputs {dict(unet_shapes)} {head_shapes}")

    per_step = {name: [] for name in MULTI_PHASES}
    saved, phase_wall_s = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = MultiPhaseTrainer(model, device=device, checkpoint_dir=os.path.join(tmp, "ckpt"),
                                    num_classes=CLASSES, log_dir=os.path.join(tmp, "logs"))

        raw_builders = (trainer._phase1_step, trainer._phase2_step, trainer._phase3_step)
        for name, build in zip(MULTI_PHASES, raw_builders):
            setattr(trainer, f"_{name}_step",
                    lambda _b=build, _n=name: counted(_b(), counters, per_step[_n]))
        real_save = trainer._save_best

        def save_and_snapshot(phase, metrics):
            """The phase checkpoint, timed, with the live model's outputs on the
            probe tiles at that moment."""
            t0 = time.perf_counter()
            real_save(phase, metrics)
            write_ms = (time.perf_counter() - t0) * 1e3
            path = trainer.checkpoint_dir / f"phase{phase}_best.pth"
            saved.append({"phase": phase, "path": str(path), "write_ms": write_ms,
                          "mb": os.path.getsize(path) / 1e6, "outputs": outputs(model)})

        trainer._save_best = save_and_snapshot
        torch.cuda.synchronize()
        reset_counts(counters)
        t_start = time.perf_counter()
        results = {}
        for name, run in (
                ("phase1", lambda: trainer.phase1_train(train_loader, val_loader, epochs=1,
                                                        learning_rate=1e-4)),
                ("phase2", lambda: trainer.phase2_train(train_loader, target_loader,
                                                        val_loader, epochs=1,
                                                        learning_rate=5e-5)),
                ("phase3", lambda: trainer.phase3_train(target_loader, val_loader, epochs=1,
                                                        learning_rate=1e-5))):
            t0 = time.perf_counter()
            results[name] = run()
            torch.cuda.synchronize()
            phase_wall_s[name] = time.perf_counter() - t0
        wall_s = time.perf_counter() - t_start
        run_counts = read_counts(counters)

        # phases 1 and 2 iterate the source train loader, phase 3 the target one
        n_steps = dict(zip(MULTI_PHASES, (len(train_loader), len(train_loader),
                                          len(target_loader))))
        steps_run = check_step_launches("multiphase", per_step, expected, n_steps, run_counts)
        if not all(np.isfinite(v) for v in results.values()) or not 0 <= results["phase1"] <= 1:
            raise AssertionError(f"phase results {results}")

        # every phase's best checkpoint reloads bit for bit
        if [s["phase"] for s in saved] != [1, 2, 3]:
            raise AssertionError(f"phase checkpoints {[s['phase'] for s in saved]}")
        for s in saved:
            ckpt = load_checkpoint(s["path"])
            if set(ckpt) != {"model_state_dict", "metrics", "phase"} or ckpt["phase"] != s["phase"]:
                raise AssertionError(f"phase {s['phase']} checkpoint holds {sorted(ckpt)}")
            reloaded = create_uda_model(MULTI_ENCODER, classes=CLASSES, seed=SEED + 1,
                                        dtype=torch.bfloat16, device=device)
            reloaded.load_state_dict(from_jax_state_dict(ckpt["model_state_dict"]), strict=True)
            got = outputs(reloaded)
            if not all(torch.equal(a, b) for a, b in zip(got, s.pop("outputs"))):
                raise AssertionError(f"phase {s['phase']}: the reloaded model's outputs differ")
            del reloaded, ckpt

        # the bare step of each phase on the final model (bare_step_report)
        dev = [tuple(torch.from_numpy(a).to(device) for a in (
            images[i:i + TRAIN_BATCH], masks[i:i + TRAIN_BATCH].astype(np.uint8),
            targets[i:i + TRAIN_BATCH])) for i in (0, TRAIN_BATCH)]
        gen = torch.Generator(device=device).manual_seed(SEED)
        turn = itertools.count()
        raw = {name: build() for name, build in zip(MULTI_PHASES, raw_builders)}
        lrs = {"phase1": 1e-4, "phase2": 5e-5, "phase3": 1e-5}
        states = {name: TrainState(model, adam(lr)) for name, lr in lrs.items()}
        bare = {
            "phase1": lambda b: raw["phase1"](states["phase1"], gen, b[0], b[1]),
            "phase2": lambda b: raw["phase2"](states["phase2"], gen, b[0], b[1], b[2], 1.0),
            "phase3": lambda b: raw["phase3"](states["phase3"], gen, b[2])}
        per_phase = {name: bare_step_report(fn, dev, turn)
                     | {"launches_per_step": per_step[name][0], "wall_s": phase_wall_s[name]}
                     for name, fn in bare.items()}

    result = {
        "model": f"UDASegmentationModel: {MULTI_ENCODER} U-Net, {CLASSES} classes, "
                 f"+ FeatureDomainDiscriminator (512/256/128)",
        "dtype": "bfloat16", "batch": TRAIN_BATCH, "tile": TILE,
        "data": f"{TRAINER_TILES} source tiles (split {TRAINER_TRAIN} / "
                f"{TRAINER_TILES - TRAINER_TRAIN}), {PIPE_TARGETS} target tiles, in memory",
        "epochs_per_phase": 1, "steps": steps_run,
        "phase2_step": "make_grl_sequential_step (lambda_domain 0.001, WEAK)",
        "phase3_step": "MultiPhaseTrainer._phase3_step (STRONG, mse + 0.1 * confusion)",
        "batch_norms": n_bn, "expected_launches_per_step": expected,
        "phases": per_phase, "phase_results": results, "launches": run_counts,
        "checkpoints": [{k: s[k] for k in ("phase", "mb", "write_ms")} for s in saved],
        "checkpoints_reload_bit_identical": True,
        "multiphase_wall_s": wall_s, "card": card}
    del model, trainer, states, raw, bare, dev
    torch.cuda.empty_cache()
    return result


def _multiphase_child(card) -> dict:
    return drive_multiphase(kernel_counters(), card, np.random.default_rng(SEED + 11))


def multiphase_phase(card) -> dict:
    """Phase 11 in a fresh process of its own (spawned, as phases 9 and 10)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_multiphase_child, (card,))


# the system phase: the port's test_system CLI, all 14 suites at the Config
# defaults (resnet34 U-Net, 23 classes, 256 px, B=8, bf16) over the synthetic
# fixtures of setup_test_data (10 source tiles split 8 / 2, 8 target tiles)
SYSTEM_DEVICE, SYSTEM_ENCODER = "cuda", "resnet34"
SYSTEM_TILE, SYSTEM_BATCH, SYSTEM_SOURCE, SYSTEM_TARGETS = 256, 8, 10, 8


def system_steps() -> dict:
    """suite -> (its train step's factory, the steps it runs): phase 1 two
    epochs over the 8 training tiles, phase 2 two epochs over all 10 source
    tiles, phase 3 one epoch over the 8 target tiles at B=1 (``drop_last``)."""
    return {"training": ("make_supervised_train_step",
                         2 * -(-int(0.8 * SYSTEM_SOURCE) // SYSTEM_BATCH)),
            "adversarial_training": ("make_adversarial_train_step",
                                     2 * -(-SYSTEM_SOURCE // SYSTEM_BATCH)),
            "unsupervised_training": ("make_unsupervised_sequential_step", SYSTEM_TARGETS)}


# the dihedral_normalize inputs of the CLI: the steps' batches (B=8, the
# remainder 2, B=1 in phase 3) and the per-item augmentations (B=1, int32 masks)
SYSTEM_DIHEDRAL = [(b, masks) for b in (8, 2, 1) for masks in (None, torch.uint8, torch.int32)]
PREDICT_BAND = 1e-4


def check_sums_quietly(ops, gen, shape, dtype) -> dict:
    """``check_sums`` untimed, its report line kept off the output."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return check_sums(ops, gen, shape, dtype, timed=False)


def check_dihedral_at(ops, host_rng, b, mask_dtype) -> int:
    """dihedral_normalize vs its plain version at (b, 256, 256, 3), bit-exact,
    for four seeded flag draws and ``normalize`` both ways; returns the calls."""
    images = torch.from_numpy(host_rng.integers(0, 256, (b, SYSTEM_TILE, SYSTEM_TILE, 3),
                                                dtype=np.uint8)).cuda()
    masks = None if mask_dtype is None else torch.from_numpy(host_rng.integers(
        0, CLASSES, (b, SYSTEM_TILE, SYSTEM_TILE)).astype(np.int32)).cuda().to(mask_dtype)
    calls = 0
    for _ in range(4):
        flags = torch.from_numpy(host_rng.integers(0, 8, b).astype(np.int32)).cuda()
        for normalize in (False, True):
            x, m = ops.dihedral_normalize(images, flags, masks, normalize=normalize)
            x_ref, m_ref = ops.dihedral_normalize_reference(images, flags, masks,
                                                            normalize=normalize)
            calls += 1
            if not torch.equal(x, x_ref) or (masks is not None and not torch.equal(m, m_ref)):
                raise AssertionError(f"dihedral_normalize is not bit-exact at ({b}, "
                                     f"{SYSTEM_TILE}, {SYSTEM_TILE}, 3), masks {mask_dtype}")
    return calls


def drive_system(counters, card, host_rng) -> dict:
    """Phase 12: the port's ``test_system`` CLI on the card (see main)."""
    import contextlib
    import io
    import warnings

    from uda_aerial_semantic_segmentation_research_tpu_torch import test_system as ts
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.inference import predict
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_discriminator,
        create_unet,
        from_jax_state_dict,
        to_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        augment,
        channel_sums as sums_ops,
        dihedral as dihedral_ops,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
        read_events,
    )

    torch.backends.cudnn.allow_tf32 = False        # the float32 predict_mask parity below
    torch.backends.cuda.matmul.allow_tf32 = False
    for key in [k for k in os.environ if k.startswith("UDA_TPU_")]:
        del os.environ[key]                        # the Config defaults, no converted weights
    unet = create_unet(SYSTEM_ENCODER, classes=CLASSES, device="cpu")
    n_unet_bn = sum(isinstance(m, BatchNorm) for m in unet.modules())
    n_disc_bn = sum(isinstance(m, BatchNorm) for m in create_discriminator(device="cpu").modules())
    expected = pipeline_expected_launches(n_unet_bn, n_disc_bn, encoder_block_bns(unet))
    del unet
    probe = torch.from_numpy(host_rng.integers(0, 256, (2, SYSTEM_TILE, SYSTEM_TILE, 3),
                                               dtype=np.uint8)).to(SYSTEM_DEVICE)

    # step launches (the trainers build their steps through these factories)
    per_step = {name: [] for name in STEP_FACTORIES}
    real_factories = {name: getattr(step_lib, name) for name in STEP_FACTORIES}
    counted_factory = lambda name: lambda *a, **k: counted(real_factories[name](*a, **k),
                                                           counters, per_step[name])
    # per-item augmentations (one dihedral_normalize each)
    item_calls, item_lock = [0], threading.Lock()
    real_item_call = augment.Augmentation.__call__

    def item_call(self, *a, **k):
        with item_lock:
            item_calls[0] += 1
        return real_item_call(self, *a, **k)

    # per suite: launches, steps, item augmentations, wall time, and the
    # snapshots the checks below need
    suites, snap = {}, {}
    real_suites = {name: getattr(ts.TestSuites, f"{name}_suite") for name in ts.ALL_SUITE_NAMES}

    def recorded(name):
        def run(*args):
            before, steps0 = read_counts(counters), {k: len(v) for k, v in per_step.items()}
            items0, threads0 = item_calls[0], set(threading.enumerate())
            t0 = time.perf_counter()
            out = real_suites[name](*args)
            # a loader abandoned after its first batch (``next(iter(loader))``)
            # leaves its producer thread fetching the next batch: wait for it,
            # so that its item augmentations count in this suite
            for thread in set(threading.enumerate()) - threads0:
                thread.join(timeout=120)
            torch.cuda.synchronize()
            after = read_counts(counters)
            ok = out[0] if isinstance(out, tuple) else out
            suites[name] = {"ok": bool(ok), "wall_s": time.perf_counter() - t0,
                            "launches": {k: after[k] - before[k] for k in after},
                            "steps": {k: len(v) - steps0[k] for k, v in per_step.items()
                                      if len(v) > steps0[k]},
                            "item_augmentations": item_calls[0] - items0}
            if name == "model_io" and ok:
                snap["model_io_logits"] = step_lib.make_predict_step(args[0])(probe).clone()
            if name == "prediction" and ok:
                snap["prediction_state"] = to_jax_state_dict(args[0])
                snap["val_image"] = args[1].dataset.load_raw(args[1].indices[0])[0]
            return out
        return staticmethod(run)

    # the BatchNorm inputs of the run that reach the sums kernels (train mode)
    bn_inputs = collections.Counter()

    def bn_hook(module, inputs):
        if isinstance(module, BatchNorm) and module.training:
            x = inputs[0]
            bn_inputs[(tuple(x.permute(0, 2, 3, 1).shape), x.dtype)] += 1

    buf = io.StringIO()
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        for name in STEP_FACTORIES:
            setattr(step_lib, name, counted_factory(name))
        for name in ts.ALL_SUITE_NAMES:
            setattr(ts.TestSuites, f"{name}_suite", recorded(name))
        augment.Augmentation.__call__ = item_call
        hook = torch.nn.modules.module.register_module_forward_pre_hook(bn_hook)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(buf):
                warnings.simplefilter("always")
                ok = ts.test_system(device=SYSTEM_DEVICE)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            run_counts = read_counts(counters)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            hook.remove()
            augment.Augmentation.__call__ = real_item_call
            for name, fn in real_suites.items():
                setattr(ts.TestSuites, f"{name}_suite", staticmethod(fn))
            for name, fn in real_factories.items():
                setattr(step_lib, name, fn)
            os.chdir(old_cwd)
        log = buf.getvalue()
        summary = [line.split() for line in log.splitlines()
                   if line.startswith("  ✓ ") or line.startswith("  ✗ ")]
        if not ok or summary != [["✓", name] for name in ts.ALL_SUITE_NAMES] \
                or any(not suites[name]["ok"] for name in ts.ALL_SUITE_NAMES):
            print(log[-6000:], flush=True)
            raise AssertionError(f"test_system: {summary}")
        config = {"encoder": Config.ENCODER_NAME, "classes": Config.NUM_CLASSES,
                  "tile": Config.IMAGE_SIZE, "batch": Config.BATCH_SIZE,
                  "dtype": Config.COMPUTE_DTYPE, "device": Config.DEVICE}
        if config != {"encoder": SYSTEM_ENCODER, "classes": CLASSES, "tile": SYSTEM_TILE,
                      "batch": SYSTEM_BATCH, "dtype": "bfloat16", "device": SYSTEM_DEVICE}:
            raise AssertionError(f"test_system ran at {config}")
        imagenet_warnings = sum("encoder stays randomly initialized" in str(w.message)
                                for w in caught)

        # the step census, and no launch outside the steps but one
        # dihedral_normalize per item augmentation
        n_steps = dict(system_steps().values())
        n_items = sum(rec["item_augmentations"] for rec in suites.values())
        steps_run = check_step_launches(
            f"system, less the {n_items} item augmentations", per_step, expected, n_steps,
            {k: run_counts[k] - n_items * (k == "dihedral_normalize") for k in run_counts})
        for name, rec in suites.items():
            in_steps = collections.Counter()
            for factory, n in rec["steps"].items():
                for c in per_step[factory][:n]:
                    in_steps.update(c)
            outside = {k: rec["launches"][k] - in_steps[k] for k in rec["launches"]}
            want = {k: rec["item_augmentations"] * (k == "dihedral_normalize") for k in outside}
            if outside != want or (name in system_steps()) != bool(rec["steps"]):
                raise AssertionError(f"suite {name}: launches outside the steps {outside}, "
                                     f"expected {want}; steps {rec['steps']}")
        if run_counts["conv_bn_relu"] or run_counts["fused_cross_entropy"]:
            raise AssertionError(f"the CLI launched {run_counts}")

        # the model_io file reloads (JAX layout, from_jax_state_dict) bit for bit
        path = pathlib.Path(tmp) / Config.CHECKPOINTS_DIR / "test_checkpoint" / "test_model.pth"
        reloaded = create_unet(SYSTEM_ENCODER, classes=CLASSES, seed=SEED + 1,
                               device=SYSTEM_DEVICE)
        reloaded.load_state_dict(from_jax_state_dict(load_checkpoint(path)), strict=True)
        if not torch.equal(step_lib.make_predict_step(reloaded)(probe), snap["model_io_logits"]):
            raise AssertionError("the model_io checkpoint does not reload bit for bit")
        model_io_mb = os.path.getsize(path) / 1e6
        del reloaded

        # log_model_graph traced the model on the card
        graph_file = next((pathlib.Path(tmp) / "test_logs").glob("*/events.out.tfevents.*"))
        graph_tags = sorted({v["tag"] for e in read_events(graph_file) for v in e["values"]
                             if v["tag"].startswith("model/")})
        if graph_tags != ["model/graph/text_summary", "model/structure/text_summary"]:
            raise AssertionError(f"log_model_graph wrote {graph_tags}")

    # predict_mask on the card against a CPU copy, both float32, outside the
    # band |p - 0.5| < 1e-4 of the CPU probabilities
    masks, probs = [], None
    for device in (SYSTEM_DEVICE, "cpu"):
        m32 = create_unet(SYSTEM_ENCODER, classes=CLASSES, dtype=torch.float32, device=device)
        m32.load_state_dict(from_jax_state_dict(snap["prediction_state"]), strict=True)
        masks.append(predict.predict_mask(m32, snap["val_image"], device=device))
        if device == "cpu":
            x = torch.from_numpy(predict._prepare_input(snap["val_image"], SYSTEM_TILE))
            with torch.inference_mode():
                probs = torch.sigmoid(m32(x)).numpy()[0]
        del m32
    clear = np.abs(probs - 0.5) >= PREDICT_BAND
    differ = masks[0] != masks[1]
    mismatched = int(differ[clear].sum())
    if masks[0].shape != (SYSTEM_TILE, SYSTEM_TILE, CLASSES) or mismatched:
        raise AssertionError(f"predict_mask on the card differs from the CPU at {mismatched} "
                             f"values outside the band")

    # the sums kernels at every BatchNorm input of the run, dihedral_normalize
    # at the CLI's batches
    gen = torch.Generator(device=SYSTEM_DEVICE).manual_seed(SEED + 12)
    sums = [check_sums_quietly(sums_ops, gen, shape, dtype) for shape, dtype in sorted(
        bn_inputs, key=lambda k: (k[0], str(k[1])))]
    dihedral_calls = sum(check_dihedral_at(dihedral_ops, host_rng, b, mask_dtype)
                         for b, mask_dtype in SYSTEM_DIHEDRAL)
    result = {
        "config": config, "ok": True,
        "suites": {name: {"ok": "✓" if rec["ok"] else "✗", "wall_s": rec["wall_s"],
                          "launches": rec["launches"], "steps": rec["steps"],
                          "item_augmentations": rec["item_augmentations"]}
                   for name, rec in suites.items()},
        "steps": steps_run, "expected_launches_per_step": expected, "launches": run_counts,
        "peak_mem_gib": peak_gib, "test_system_wall_s": wall_s,
        "imagenet_missing_warnings": imagenet_warnings,
        "model_io_reload_bit_identical": True, "model_io_mb": model_io_mb,
        "log_model_graph_tags": graph_tags,
        "predict_mask_card_vs_cpu_f32": {
            "values": int(probs.size), "in_band": int((~clear).sum()), "band": PREDICT_BAND,
            "mismatched_outside_band": mismatched,
            "mismatched_in_band": int(differ[~clear].sum())},
        "sums_checked": [{"shape": r["shape"], "dtype": r["dtype"],
                          "batch_norms": bn_inputs[(tuple(r["shape"]), getattr(torch, r["dtype"]))],
                          "max_rel_err": r["max_rel_err"], "max_abs_err": r["max_abs_err"]}
                         for r in sums],
        "sums_tolerance": "1e-5 * sum|terms|; two launches bit-identical",
        "dihedral_checked": {"shapes": [[b, SYSTEM_TILE, SYSTEM_TILE, 3, dtype_name(m) if m
                                         else None] for b, m in SYSTEM_DIHEDRAL],
                             "calls": dihedral_calls, "tolerance": "bit-exact"},
        "card": card}
    torch.cuda.empty_cache()
    return result


def _system_child(card) -> dict:
    return drive_system(kernel_counters(), card, np.random.default_rng(SEED + 12))


def system_phase(card) -> dict:
    """Phase 12 in a fresh process of its own (spawned, as phases 9-11)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_system_child, (card,))


# the phase-3 production point (``bench.py --mode unsup``): the resnet34 U-Net
# with encoder remat and bf16 logits under the sequential step with a bf16
# carry, FineTuningLoss() defaults; the batch ladder of the JAX bench
PROD_LADDER, PROD_EPOCH = (128, 64, 32), 20.0
PROD_LR = {"phase2": 1e-4, "phase3": 1e-5}
UNSUP_LOSSES = ("total", "consistency", "domain_confusion", "supervised", "rampup_weight",
                "domain_prob")


def update_snapshot(models) -> dict:
    """Every parameter, gradient and buffer of ``models`` after an update (clones)."""
    out = {}
    for i, m in enumerate(models):
        for k, p in m.named_parameters():
            out[f"{i}/param/{k}"] = p.detach().clone()
            out[f"{i}/grad/{k}"] = (torch.zeros_like(p) if p.grad is None
                                    else p.grad.detach().clone())
        out.update({f"{i}/buffer/{k}": b.clone() for k, b in m.named_buffers()})
    return out


def hold_update(label, ref, other, lr, grad_tol, buffer_tol=None) -> dict:
    """``other``, one update from the same state on the same draws as
    ``ref``: every BatchNorm buffer bit-identical (within ``buffer_tol``
    where given); every clipped gradient
    within ``grad_tol`` of its tensor's largest entry (a tensor whose
    largest is below 1e-6 of the network's, such as a conv bias in front
    of a BatchNorm, against that 1e-6); the parameters by the
    Adam-sign rule (tests/test_torch_adversarial.py): Adam's first update is
    ``lr * g / (|g| + eps)``, +-lr whatever |g|, so a gradient entry whose
    sign is float noise moves +lr in one run and -lr in the other.  Every
    entry within ``2.5 * lr`` of ``ref``'s, plus one float32 ulp of the
    parameter; entries whose gradient is at least 10% of their tensor's
    largest (in a tensor whose largest is at least 1e-6 of the network's:
    a conv bias in front of a BatchNorm has none) within ``0.02 * lr`` plus
    one ulp: their sign is not noise."""
    buffers = [k for k in ref if "/buffer/" in k]
    buffer_err = max((other[k] - ref[k]).abs().max().item() for k in buffers)
    moved = [k for k in buffers if not torch.equal(ref[k], other[k])]
    if moved if buffer_tol is None else not buffer_err <= buffer_tol:
        raise AssertionError(f"{label}: BatchNorm buffers differ by {buffer_err}: {moved[:5]}")
    params = [k for k in ref if "/param/" in k]
    grads = {k: ref[k.replace("/param/", "/grad/")] for k in params}
    largest = max(g.abs().max().item() for g in grads.values())
    grad_err, grad_worst = 0.0, None
    for k, g in grads.items():
        scale = max(g.abs().max().item(), 1e-6 * largest)
        err = (other[k.replace("/param/", "/grad/")] - g).abs().max().item() / scale
        if err > grad_err:
            grad_err, grad_worst = err, k
    if not grad_err <= grad_tol:
        raise AssertionError(f"{label}: gradient {grad_worst} off by {grad_err} of its "
                             f"tensor's largest (tolerance {grad_tol})")
    worst = worst_significant = 0.0
    significant = total = 0
    for k in params:
        excess = ((other[k] - ref[k]).abs()
                  - torch.finfo(torch.float32).eps * ref[k].abs()) / lr
        worst = max(worst, excess.max().item())
        g, gmax = grads[k].abs(), grads[k].abs().max()
        total += g.numel()
        if gmax >= 1e-6 * largest:
            mask = g >= 0.1 * gmax
            significant += int(mask.sum())
            worst_significant = max(worst_significant, excess[mask].max().item())
    if worst > 2.5 or worst_significant > 0.02:
        raise AssertionError(f"{label}: parameters off by {worst} lr (significant entries "
                             f"{worst_significant} lr)")
    return {"buffers_bit_identical": len(buffers) - len(moved), "buffer_max_abs_err": buffer_err,
            "grad_max_err_of_largest": grad_err, "grad_worst": grad_worst,
            "param_max_excess_lr": worst, "significant_param_max_excess_lr": worst_significant,
            "significant_share": significant / total,
            "tolerance": f"gradients {grad_tol} of each tensor's largest; parameters: every "
                         "entry 2.5 lr, entries with |g| >= 10% of their tensor's largest "
                         "0.02 lr, each plus one float32 ulp; buffers "
                         + ("bit-identical" if buffer_tol is None else f"within {buffer_tol}")}


def hold_metrics(label, ref, other, keys, rtol=1e-6) -> dict:
    """Loss scalars of two runs of one update within ``rtol``."""
    errs = {}
    for k in keys:
        a, b = ref[k].float(), other[k].float()
        errs[k] = ((a - b).abs() / a.abs().clamp_min(1e-30)).max().item()
        if not errs[k] <= rtol:
            raise AssertionError(f"{label}: {k} {b.tolist()} against {a.tolist()}")
    return {"max_rel_err": max(errs.values()), "rtol": rtol}


def measure_step(fn, batches, counters) -> dict:
    """A bare step ``fn(batch)`` on batches already on the card: p50 of 5 after
    one warm-up (CUDA events), the peak memory from a reset, the launches of
    one step, and one step under ``set_sync_debug_mode("error")`` (a host
    sync raises)."""
    turn = itertools.count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: fn(batches[next(turn) % len(batches)]), reps=5, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    before = read_counts(counters)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(batches[next(turn) % len(batches)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = read_counts(counters)
    return {"bare_step_ms_p50": ms, "tiles_per_s": batches[0][0].shape[0] / ms * 1e3,
            "peak_mem_gib": peak_gib, "host_syncs_per_step": 0,
            "launches_per_step": {k: after[k] - before[k] for k in after}}


def drive_production(counters, card, host_rng) -> dict:
    """Phase 13: the memory-decomposed phases 2 and 3 and the phase-3
    production point on the card (see main)."""
    import gc

    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        DomainAdaptationModel,
        create_discriminator,
        create_unet,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        batch_norm as bn_mod,
        channel_sums as sums_ops,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import FineTuningLoss
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        steps as step_lib,
        unsupervised_trainer,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        AdversarialState,
        TrainState,
        adam,
    )

    device = torch.device(PIPE_DEVICE)
    seg0 = create_unet(PIPE_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                       device=device)
    disc0 = create_discriminator(seed=SEED + 1, dtype=torch.bfloat16, device=device)
    n_unet_bn = sum(isinstance(m, BatchNorm) for m in seg0.modules())
    n_disc_bn = sum(isinstance(m, BatchNorm) for m in disc0.modules())
    expected = pipeline_expected_launches(n_unet_bn, n_disc_bn, encoder_block_bns(seg0))

    def batch(b):
        return tuple(torch.from_numpy(a).to(device) for a in (
            host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8),
            host_rng.integers(0, CLASSES, (b, TILE, TILE), dtype=np.uint8),
            host_rng.integers(0, 256, (b, TILE, TILE, 3), dtype=np.uint8)))

    dev = [batch(TRAIN_BATCH) for _ in range(2)]      # (source, masks, target) x 2

    # the step variants: (name, factory over fresh models, phase, step(state, gen, b))
    def unsup(make, remat=False, logits=torch.float32, **kw):
        def build(seg, disc):
            if remat or logits != torch.float32:
                seg = seg.clone(remat=remat, logits_dtype=logits)
            return make(seg, disc, CLASSES, FineTuningLoss(), **kw)
        return build

    variants = {
        "phase3_joint": ("make_unsupervised_train_step",
                         unsup(step_lib.make_unsupervised_train_step)),
        "phase3_sequential": ("sequential, no remat",
                              unsup(step_lib.make_unsupervised_sequential_step)),
        "phase3_sequential_remat": ("make_unsupervised_sequential_step",
                                    unsup(step_lib.make_unsupervised_sequential_step,
                                          remat="encoder")),
        "phase3_production": ("make_unsupervised_sequential_step",
                              unsup(step_lib.make_unsupervised_sequential_step,
                                    remat="encoder", logits=torch.bfloat16,
                                    carry_dtype=torch.bfloat16)),
        "phase2": ("make_adversarial_train_step",
                   lambda seg, disc: step_lib.make_adversarial_train_step(seg, disc, CLASSES)),
    }

    def instantiate(name):
        """Fresh copies of the seeded models, their state and the step."""
        seg, disc = copy.deepcopy(seg0), copy.deepcopy(disc0)
        name = name.removesuffix(" again")
        if name.startswith("phase3"):
            state = TrainState(DomainAdaptationModel(seg, disc),
                               adam(PROD_LR["phase3"], clip_norm=1.0), skip_nonfinite=True)
        else:
            state = AdversarialState(TrainState(seg, adam(PROD_LR["phase2"])),
                                     TrainState(disc, adam(PROD_LR["phase2"])))
        step = variants[name][1](seg, disc)
        if name.startswith("phase3"):
            return seg, disc, state, lambda gen, b: step(state, gen, b[2], PROD_EPOCH)[1]
        return seg, disc, state, lambda gen, b: step(state, gen, b[0], b[1], b[2])[1]

    # BatchNorm inputs whose statistics are frozen: the recompute (and
    # grad_view1's forward), for the sums checks below
    frozen_inputs = collections.Counter()

    def frozen_hook(module, inputs):
        if isinstance(module, BatchNorm) and module.training and bn_mod.statistics_frozen():
            x = inputs[0]
            frozen_inputs[(tuple(x.permute(0, 2, 3, 1).shape), x.dtype)] += 1

    # 1. one update of each variant on the same draws, held against its reference
    runs = {}
    hook = torch.nn.modules.module.register_module_forward_pre_hook(frozen_hook)
    try:
        for name in ("phase3_joint", "phase3_joint again", "phase3_sequential",
                     "phase3_sequential_remat"):
            seg, disc, state, run = instantiate(name)
            before = read_counts(counters)
            metrics = run(torch.Generator(device=device).manual_seed(SEED + 13), dev[0])
            torch.cuda.synchronize()
            after = read_counts(counters)
            launches = {k: after[k] - before[k] for k in after}
            factory = variants[name.removesuffix(" again")][0]
            if launches != expected[factory]:
                raise AssertionError(f"{name}: launches {launches}, expected {expected[factory]}")
            if not bool(metrics["finite"]):
                raise AssertionError(f"{name}: the update was not finite")
            runs[name] = (metrics, update_snapshot((seg, disc)), launches)
            del seg, disc, state, run
            torch.cuda.empty_cache()
    finally:
        hook.remove()
    # gradient tolerances: a step repeated, or its forward recomputed, runs
    # the same kernels on the same values (1e-6 leaves room for a kernel
    # that adds in a varying order); the sequential step adds the same
    # terms as the joint backward in another order, in float32 (1e-5, as
    # tests/test_torch_sequential_steps.py on the CPU)
    held = {}
    for label, ref, other, grad_tol in (
            ("joint vs joint (phase 3, reproducibility)", "phase3_joint",
             "phase3_joint again", 1e-6),
            ("sequential vs joint (phase 3)", "phase3_joint", "phase3_sequential", 1e-5),
            ("encoder remat vs none (sequential phase 3)", "phase3_sequential",
             "phase3_sequential_remat", 1e-6)):
        held[label] = {"metrics": hold_metrics(label, runs[ref][0], runs[other][0],
                                               UNSUP_LOSSES),
                       "update": hold_update(label, runs[ref][1], runs[other][1],
                                             PROD_LR["phase3"], grad_tol)}
        print(f"phase 13 held: {label} {json.dumps(held[label])}", flush=True)
    del runs
    torch.cuda.empty_cache()

    # 2. bare steps at B=32: time, tiles/s, peak memory, launches, host syncs
    timed = {}
    for name in variants:
        seg, disc, state, run = instantiate(name)
        gen = torch.Generator(device=device).manual_seed(SEED + 14)
        rec = measure_step(lambda b: run(gen, b), dev, counters)
        if rec["launches_per_step"] != expected[variants[name][0]]:
            raise AssertionError(f"{name}: launches {rec['launches_per_step']}")
        if name == "phase3_production":
            prof = profile_forward(lambda: run(gen, dev[0]), reps=2)
            rec.update({"device_ms": prof.get("device_ms_per_call"),
                        "busy_share": prof.get("busy_share"),
                        "by_category_ms": prof.get("by_category_ms")})
        timed[name] = rec
        print(f"phase 13 step {name}: {json.dumps(rec)}", flush=True)
        del seg, disc, state, run
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("phase3_sequential", "phase3_production"):
        if not timed[name]["peak_mem_gib"] < timed["phase3_joint"]["peak_mem_gib"]:
            raise AssertionError(f"{name} peaks at {timed[name]['peak_mem_gib']} GiB, the "
                                 f"joint step at {timed['phase3_joint']['peak_mem_gib']}")
    del dev

    # 3. the batch ladder of the production point; an out-of-memory is a row
    ladder, largest = [], None
    for b in PROD_LADDER:
        seg = disc = state = run = batches = None
        try:
            batches = [batch(b) for _ in range(2)]
            seg, disc, state, run = instantiate("phase3_production")
            gen = torch.Generator(device=device).manual_seed(SEED + 15)
            rec = measure_step(lambda x: run(gen, x), batches, counters)
            hook = torch.nn.modules.module.register_module_forward_pre_hook(frozen_hook)
            try:
                run(gen, batches[0])
            finally:
                hook.remove()
            largest = {"batch": b, **rec}
            ladder.append({"batch": b, "fits": True})
        except torch.cuda.OutOfMemoryError as e:
            ladder.append({"batch": b, "fits": False, "error": str(e).splitlines()[0][:160]})
        finally:
            del seg, disc, state, run, batches
            gc.collect()
            torch.cuda.empty_cache()
        print(f"phase 13 ladder: {json.dumps(ladder[-1])}", flush=True)
        if largest is not None:
            break
    if largest is None:
        raise AssertionError(f"the production point fits no batch of {PROD_LADDER}")

    # 4. UnsupervisedTrainer with its defaults on the card: one epoch of 2 steps
    targets = host_rng.integers(0, 256, (2 * TRAIN_BATCH, TILE, TILE, 3), dtype=np.uint8)
    val = InMemoryTiles(host_rng.integers(0, 256, (16, TILE, TILE, 3), dtype=np.uint8),
                        host_rng.integers(0, CLASSES, (16, TILE, TILE)).astype(np.int32))
    name = "make_unsupervised_sequential_step"
    per_step, real = {name: []}, step_lib.make_unsupervised_sequential_step
    with tempfile.TemporaryDirectory() as tmp:
        old_logs = Config.LOGS_DIR
        Config.LOGS_DIR = tmp
        step_lib.make_unsupervised_sequential_step = (
            lambda *a, **k: counted(real(*a, **k), counters, per_step[name]))
        hook = torch.nn.modules.module.register_module_forward_pre_hook(frozen_hook)
        try:
            seg, disc = copy.deepcopy(seg0), copy.deepcopy(disc0)
            trainer = unsupervised_trainer.UnsupervisedTrainer(DomainAdaptationModel(seg, disc),
                                                               device=device)
            resolved = (trainer.remat, trainer.sequential, trainer.carry_dtype)
            if resolved != ("encoder", True, torch.bfloat16):
                raise AssertionError(f"the trainer resolved to {resolved}")
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            trainer.train(DataLoader(InMemoryTargets(targets), batch_size=TRAIN_BATCH,
                                     shuffle=True, drop_last=True),
                          DataLoader(val, batch_size=TRAIN_BATCH), epochs=1,
                          learning_rate=PROD_LR["phase3"])
            torch.cuda.synchronize()
            trainer_wall_s = time.perf_counter() - t0
            run_counts = read_counts(counters)
        finally:
            hook.remove()
            step_lib.make_unsupervised_sequential_step = real
            Config.LOGS_DIR = old_logs
        if seg.remat is not False or seg.logits_dtype != torch.float32:
            raise AssertionError("the trainer changed the model's own remat or logits dtype")
        trainer_steps = check_step_launches("production trainer", per_step, expected,
                                            {name: 2}, run_counts)
        del trainer, seg, disc
    torch.cuda.empty_cache()

    # 5. the sums kernels at every BatchNorm input with frozen statistics
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    sums = [check_sums_quietly(sums_ops, gen, shape, dtype) for shape, dtype in sorted(
        frozen_inputs, key=lambda k: (k[0], str(k[1])))]
    result = {
        "model": f"{PIPE_ENCODER} U-Net, {CLASSES} classes, + DomainDiscriminator",
        "dtype": "bfloat16", "tile": TILE, "batch": TRAIN_BATCH,
        "production_point": "remat='encoder', logits_dtype=bfloat16, "
                            "make_unsupervised_sequential_step(carry_dtype=bfloat16), "
                            "FineTuningLoss() defaults, epoch 20",
        "expected_launches_per_step": {variants[n][0]: expected[variants[n][0]]
                                       for n in variants},
        "held_at_b32": held, "steps_b32": timed,
        "ladder": ladder, "largest_batch": largest,
        "trainer": {"resolved": {"remat": "encoder", "sequential": True,
                                 "carry_dtype": "bfloat16"},
                    "steps": trainer_steps, "wall_s": trainer_wall_s},
        "launches": run_counts,
        "frozen_statistics_sums_checked": [
            {"shape": r["shape"], "dtype": r["dtype"], "max_rel_err": r["max_rel_err"],
             "max_abs_err": r["max_abs_err"],
             "forwards": frozen_inputs[(tuple(r["shape"]), getattr(torch, r["dtype"]))]}
            for r in sums],
        "sums_tolerance": "1e-5 * sum|terms|; two launches bit-identical",
        "card": card}
    return result


def _production_child(card) -> dict:
    return drive_production(kernel_counters(), card, np.random.default_rng(SEED + 13))


def production_phase(card) -> dict:
    """Phase 13 in a fresh process of its own (spawned, as phases 9-12)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_production_child, (card,))


# the architectures phase: the other families of create_model at resnet34 and
# the U-Net at mobilenet_v2, 23 classes, 512 px, bf16, seeded weights
ARCH_MODELS = (("FPN", "resnet34"), ("PSPNet", "resnet34"), ("Linknet", "resnet34"),
               ("UnetPlusPlus", "resnet34"), ("DeepLabV3Plus", "resnet34"), ("PAN", "resnet34"),
               ("MAnet", "resnet34"), ("Unet", "mobilenet_v2"))
# train-mode BatchNorms of each model (one channel_sums and one
# channel_dual_sums a train step each), counted from the module trees
ARCH_BATCH_NORMS = {"FPN": 40, "PSPNet": 41, "Linknet": 51, "UnetPlusPlus": 56,
                    "DeepLabV3Plus": 45, "PAN": 49, "MAnet": 45, "Unet": 62}
ARCH_STEPS = 3
ARCH_PROFILED = ("PSPNet", "DeepLabV3Plus", "Unet")   # device time by kind
ARCH_SMALL_BATCH, ARCH_SMALL_TILE = 4, 128    # the float32 step on the card and the CPU
# the resize kernels (the models' bilinear / antialiased / nearest-exact, and
# the WEAK distortion's grid) apart from the augmentation's other kinds
ARCH_PROFILE_CATEGORIES = ([("resize (upsample kernels)", ("upsample",))]
                           + PROFILE_CATEGORIES)


def arch_model(create_model, name, encoder, dtype, device):
    """``create_model`` as a user calls it; the mobilenet U-Net serves with
    ``fused_eval`` (the conv_bn_relu kernel, 2 launches a forward)."""
    kw = {"fused_eval": True} if name == "Unet" else {}
    return create_model(name, encoder, encoder_weights=None, classes=CLASSES, seed=SEED,
                        dtype=dtype, device=device, **kw)


def sums_path(sums_ops, shape) -> str:
    """Which kernel of csrc/channel_sums.cu a bf16 (..., C) input takes."""
    m, c = math.prod(shape[:-1]), shape[-1]
    return "bulk" if sums_ops.plan(m, c, 2, 2, True, (1, 1, 1, 1), 132).cluster else "generic"


def check_resize_on_card(architectures) -> dict:
    """The models' resize on the card: every route keeps channels_last, and
    whether the antialiased bilinear has a bf16 kernel with a backward there
    (the port resizes a bf16 downsampling in float32 on every device, since
    the CPU has none)."""
    x = torch.randn(32, 512, 16, 16, device=PIPE_DEVICE).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    for h, method in ((2, "linear"), (128, "bilinear"), (32, "nearest")):
        y = architectures._upsample_to(x, h, h, method)
        if y.dtype != torch.bfloat16 or not y.permute(0, 2, 3, 1).is_contiguous():
            raise AssertionError(f"resize to {h} ({method}) gave {y.dtype}, not channels_last")
    probe = x.detach().requires_grad_()
    try:
        y = F.interpolate(probe, size=(2, 2), mode="bilinear", align_corners=False, antialias=True)
        y.float().sum().backward()
        torch.cuda.synchronize()
        aa = {"bf16_antialiased_forward_backward": True,
              "output_channels_last": y.permute(0, 2, 3, 1).is_contiguous(),
              "grad_channels_last": probe.grad.permute(0, 2, 3, 1).is_contiguous()}
    except (RuntimeError, NotImplementedError) as e:
        aa = {"bf16_antialiased_forward_backward": False, "error": str(e).splitlines()[0][:160]}
    return {"routes_channels_last": True, **aa}


def moved_check(label, before, model):
    """Every BatchNorm buffer moved; a parameter left as it was must have had
    an all-zero gradient (the PAB key's bias under the softmax can)."""
    after = model.state_dict()
    grads = {k: p.grad for k, p in model.named_parameters()}
    stuck = [k for k, v in before.items() if torch.equal(v, after[k])]
    unexplained = [k for k in stuck if k not in grads or grads[k] is None
                   or bool(grads[k].any())]
    if unexplained:
        raise AssertionError(f"{label}: left unchanged by training: {unexplained[:5]}")
    return stuck


def arch_train(label, model, n_bn, batches, counters, gen, profiled):
    """The census step on a copy, ``ARCH_STEPS`` counted steps, the bare step
    (``measure_step``) and, for ``profiled``, the device time by kind."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_supervised_train_step,
    )

    census = collections.Counter()

    def record(mod, inp):
        if not inp[0].permute(0, 2, 3, 1).is_contiguous():
            raise AssertionError(f"{label}: a BatchNorm input is not channels_last")
        census[tuple(inp[0].permute(0, 2, 3, 1).shape)] += 1

    warm = copy.deepcopy(model)
    for m in warm.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(record)
    make_supervised_train_step(warm, CLASSES)(TrainState(warm, adam(1e-4)),
                                              torch.Generator(device=PIPE_DEVICE).manual_seed(SEED),
                                              *batches[0])
    torch.cuda.synchronize()
    del warm
    torch.cuda.empty_cache()
    if sum(census.values()) != n_bn:
        raise AssertionError(f"{label}: {sum(census.values())} BatchNorm inputs, {n_bn} modules")

    state = TrainState(model, adam(1e-4))
    train_step = make_supervised_train_step(model, CLASSES)        # WEAK, plain CE
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    per_step, losses = [], []
    run = counted(train_step, counters, per_step)
    for images, masks in batches:
        state, metrics = run(state, gen, images, masks)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    expected = {"conv_bn_relu": 0, "channel_sums": n_bn, "channel_dual_sums": n_bn,
                "dihedral_normalize": 1, "fused_cross_entropy": 0}
    if any(c != expected for c in per_step):
        raise AssertionError(f"{label}: launches per step {per_step}, expected {expected}")
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: train losses {losses}")
    stuck = moved_check(label, before, model)
    del before
    dev = [tuple(torch.from_numpy(a).to(PIPE_DEVICE) for a in b) for b in batches[:2]]
    rec = measure_step(lambda b: train_step(state, gen, *b), dev, counters)
    if rec["launches_per_step"] != expected:
        raise AssertionError(f"{label}: bare-step launches {rec['launches_per_step']}")
    out = {"batch": len(batches[0][0]), "batch_norm_inputs": {str(s): n for s, n in
                                                              sorted(census.items())},
           "losses": losses, "launches_per_step": expected,
           "params_unchanged_zero_grad": stuck, **rec}
    if profiled:
        prof = profile_forward(lambda: train_step(state, gen, *dev[0]), reps=2,
                               categories=ARCH_PROFILE_CATEGORIES)
        out.update({"device_ms": prof.get("device_ms_per_call"),
                    "busy_share": prof.get("busy_share"),
                    "by_category_ms": prof.get("by_category_ms"),
                    "by_category_launches": prof.get("by_category_launches"),
                    "top_kernels": prof.get("top_kernels")})
    del state, train_step, dev
    return out, census


def arch_train_model(counters, host_rng, n_bn) -> dict:
    """``train_model`` with ``Config.MODEL_NAME = "DeepLabV3Plus"`` on the card
    for 1 epoch over 80 in-memory 512 px tiles (phase 9's; 64 train tiles, B=32:
    2 steps); its ``final_model.pth`` reloaded through ``from_jax_state_dict``
    gives bit-identical logits."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.data import dataset as dataset_mod
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_model,
        from_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import train as train_mod
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    images = host_rng.integers(0, 256, (TRAINER_TILES, TILE, TILE, 3), dtype=np.uint8)
    masks = host_rng.integers(0, CLASSES, (TRAINER_TILES, TILE, TILE)).astype(np.int32)
    counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
    _, weights = dataset_mod.class_balance(
        [{c: int(n[c]) for c in np.nonzero(n)[0]} for n in counts], [m.size for m in masks])

    class InMemoryDroneDataset(InMemoryTiles):
        """The tiles behind ``DroneDataset``'s constructor and sampler."""

        def __init__(self, images_dir=None, masks_dir=None, balance_classes=True,
                     image_size=None):
            super().__init__(images, masks)

        def get_sampler(self, indices=None):
            w = weights[list(indices)] if indices is not None else weights
            return dataset_mod.WeightedRandomSampler(w / w.sum(), num_samples=len(w))

    settings = {"MODEL_NAME": "DeepLabV3Plus", "ENCODER_NAME": "resnet34",
                "ENCODER_WEIGHTS": None, "IMAGE_SIZE": TILE, "BATCH_SIZE": TRAIN_BATCH,
                "NUM_CLASSES": CLASSES, "DEVICE": PIPE_DEVICE}
    with tempfile.TemporaryDirectory() as tmp:
        for name, sub in (("DATA_DIR", "data"), ("LOGS_DIR", "logs"),
                          ("CHECKPOINTS_DIR", "ckpt"), ("CHECKPOINT_DIR", "final")):
            settings[name] = os.path.join(tmp, sub)
        old = {k: getattr(Config, k) for k in settings}
        real_dataset = dataset_mod.DroneDataset
        try:
            for k, v in settings.items():
                setattr(Config, k, v)
            dataset_mod.DroneDataset = InMemoryDroneDataset
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            model, _ = train_mod.train_model(epochs=1)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            run_counts = read_counts(counters)
            path = os.path.join(settings["CHECKPOINT_DIR"], "final_model.pth")
            final = load_checkpoint(path)
            final_mb = os.path.getsize(path) / 2 ** 20
        finally:
            dataset_mod.DroneDataset = real_dataset
            for k, v in old.items():
                setattr(Config, k, v)
    steps = -(-int(0.8 * TRAINER_TILES) // TRAIN_BATCH)
    expected = {"conv_bn_relu": 0, "channel_sums": steps * n_bn,
                "channel_dual_sums": steps * n_bn, "dihedral_normalize": steps,
                "fused_cross_entropy": 0}
    if run_counts != expected:
        raise AssertionError(f"train_model launches {run_counts}, expected {expected}")
    if type(model).__name__ != "DeepLabV3Plus":
        raise AssertionError(f"train_model built {type(model).__name__}")
    reloaded = create_model("DeepLabV3Plus", "resnet34", classes=CLASSES, seed=SEED + 1,
                            dtype=torch.bfloat16, device=PIPE_DEVICE)
    reloaded.load_state_dict(from_jax_state_dict(final["model_state_dict"]), strict=True)
    probe = torch.from_numpy(images[-2:]).to(PIPE_DEVICE)
    if not torch.equal(make_predict_step(model)(probe), make_predict_step(reloaded)(probe)):
        raise AssertionError("final_model.pth does not reload bit for bit")
    return {"model_name": "DeepLabV3Plus", "epochs": 1, "steps": steps, "launches": run_counts,
            "wall_s": wall_s, "final_model_mb": final_mb, "reloaded_bit_for_bit": True}


def drive_architectures(counters, card, host_rng) -> dict:
    """Phase 14: the other families of ``create_model`` and the mobilenet_v2
    U-Net on the card (see main)."""
    import gc

    from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
        predict_batch,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        architectures,
        create_model,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        augment,
        channel_sums as sums_ops,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
    )

    # float32 convolutions as float32 (phase 7 sets the same in the parent)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    resize = check_resize_on_card(architectures)
    print(f"phase 14 resize: {json.dumps(resize)}", flush=True)
    serve = host_rng.integers(0, 256, (TRAIN_BATCH, TILE, TILE, 3), dtype=np.uint8)
    batches = train_batches(host_rng, ARCH_STEPS, batch=TRAIN_BATCH, tile=TILE)
    draws = f32_draws(augment, host_rng, ARCH_SMALL_BATCH, ARCH_SMALL_TILE)

    models, census_all, run_counts = {}, collections.Counter(), collections.Counter()
    for name, encoder in ARCH_MODELS:
        label = f"{name}({encoder})"
        model = arch_model(create_model, name, encoder, torch.bfloat16, PIPE_DEVICE)
        n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
        if n_bn != ARCH_BATCH_NORMS[name]:
            raise AssertionError(f"{label}: {n_bn} BatchNorms, predicted {ARCH_BATCH_NORMS[name]}")

        # serving: predict_batch, then the forward alone (CUDA events) and its peak
        reset_counts(counters)
        preds = predict_batch(model, serve, device=PIPE_DEVICE)
        torch.cuda.synchronize()
        serve_counts = read_counts(counters)
        run_counts.update(serve_counts)
        want = {k: 0 for k in serve_counts} | {"conv_bn_relu": 2 if name == "Unet" else 0}
        if serve_counts != want:
            raise AssertionError(f"{label}: serving launches {serve_counts}, expected {want}")
        if (preds.shape != (TRAIN_BATCH, TILE, TILE) or preds.min() < 0
                or preds.max() >= CLASSES):
            raise AssertionError(f"{label}: predict_batch gave {preds.shape}")
        step = make_predict_step(model)
        x = torch.from_numpy(serve).to(PIPE_DEVICE)
        logits = step(x)
        if not torch.isfinite(logits).all() or tuple(logits.shape) != (TRAIN_BATCH, TILE, TILE,
                                                                         CLASSES):
            raise AssertionError(f"{label}: serving logits not finite or misshapen")
        del logits
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        forward_ms = time_ms(lambda: step(x), reps=10)
        serving = {"forward_ms": forward_ms, "tiles_per_s": TRAIN_BATCH / forward_ms * 1e3,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "launches": serve_counts}
        del step, x
        torch.cuda.empty_cache()

        # training at B=32 (the largest peak is ~13 GiB on an H100 80GB)
        gen = torch.Generator(device=PIPE_DEVICE).manual_seed(SEED + 14)
        reset_counts(counters)
        training, census = arch_train(label, model, n_bn, batches, counters, gen,
                                      name in ARCH_PROFILED)
        run_counts.update(read_counts(counters))
        census_all.update(census)
        del model
        gc.collect()
        torch.cuda.empty_cache()

        head = "segmentation_head.weight" if name == "Unet" else "head.weight"
        f32 = f32_step_card_vs_cpu(label, arch_model(create_model, name, encoder,
                                                     torch.float32, "cpu"),
                                   draws, counters, head)
        models[label] = {"batch_norms": n_bn, "serving": serving, "training": training,
                         "f32_step_gpu_vs_cpu": f32}
        print(f"phase 14 model {label}: {json.dumps(models[label])}", flush=True)

    # train_model with a non-U-Net Config.MODEL_NAME
    entry = arch_train_model(counters, host_rng, ARCH_BATCH_NORMS["DeepLabV3Plus"])
    run_counts.update(entry["launches"])
    print(f"phase 14 train_model: {json.dumps(entry)}", flush=True)

    # the sums kernels at every BatchNorm input shape no earlier phase covers
    covered = set(BN_SHAPES) | set(DISC_BN_SHAPES) | set(UDA_UNET_BN_SHAPES) | set(
        UDA_HEAD_BN_SHAPES)
    gen = torch.Generator(device=PIPE_DEVICE).manual_seed(SEED + 15)
    sums = []
    for shape in sorted(s for s in census_all if s not in covered):
        r = check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
        vectors = shape[-1] // 8 if shape[-1] % 8 == 0 else None   # bf16
        sums.append({k: r[k] for k in PER_SHAPE_KEYS}
                    | {"path": sums_path(sums_ops, shape), "batch_norms": census_all[shape],
                       "vectors_per_row": vectors,
                       "consumers": vectors and sums_ops.bulk_consumers(vectors),
                       "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
                       "sums_library_is": "torch.var_mean",
                       "sums_share_of_bound": r["sums_share_of_bound"],
                       "dual_share_of_bound": r["dual_share_of_bound"]})
    # the rows that hold no power of two of vectors: the mobilenet U-Net's
    # and DeepLabV3Plus's census of them, all on the bulk path, and the
    # mobilenet U-Net's a step
    widened = {}
    for label, want in (("Unet(mobilenet_v2)", MOBILENET_UNET_WIDENED),
                        ("DeepLabV3Plus(resnet34)", DEEPLAB_WIDENED)):
        got = {ast.literal_eval(k): n for k, n in
               models[label]["training"]["batch_norm_inputs"].items()}
        odd = {s: n for s, n in got.items()
               if s[-1] % 8 or sums_ops.bulk_consumers(s[-1] // 8) < sums_ops.THREADS}
        if odd != want:
            raise AssertionError(f"{label}: rows of no power of two of vectors {odd}, "
                                 f"expected {want}")
        paths = {sums_path(sums_ops, s) for s in odd}
        if paths != {"bulk"}:
            raise AssertionError(f"{label}: a widened input takes the {paths} path")
        widened[label] = {"inputs": sum(odd.values()), "of": sum(got.values()),
                          "shapes": len(odd), "paths": sorted(paths)}
    widened["mobilenet_unet_per_step"] = widened_per_step(sums, MOBILENET_UNET_WIDENED)
    print(f"phase 14 widened sums: {json.dumps(widened)}", flush=True)
    return {"models": models, "train_model": entry, "resize_on_card": resize,
            "sums_new_shapes": sums, "sums_widened": widened, "launches": dict(run_counts),
            "card": card}


def _architectures_child(card) -> dict:
    return drive_architectures(kernel_counters(), card, np.random.default_rng(SEED + 14))


def architectures_phase(card) -> dict:
    """Phase 14 in a fresh process of its own (spawned, as phases 9-13)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_architectures_child, (card,))


# ---------------------------------------------------------------------------
# the capture check of each kernel (3c) and phases 15-16
# ---------------------------------------------------------------------------
def raw_bits(t):
    """A tensor's bits as integers (any float dtype), so NaN equals NaN."""
    t = t.detach()
    if t.is_floating_point():
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    return t


def same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(raw_bits(a), raw_bits(b))


def captured_vs_eager(fn, replays: int = 3) -> dict:
    """``fn()`` (a tuple of tensors) launched alone inside a CUDA graph --
    captured on a side stream after one launch there, which makes that
    stream's scratch -- and replayed ``replays`` times, each replay's
    outputs held bit for bit against the eager launch on the default stream."""
    eager = [t.detach().clone() for t in fn()]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        outs = fn()
    for _ in range(replays):
        for t in outs:
            t.detach().zero_()            # stale values cannot pass for a replay's
        graph.replay()
        torch.cuda.synchronize()
        if not all(same_bits(g, e) for g, e in zip(outs, eager)):
            raise AssertionError("a replay of the captured launch differs from the eager one")
    del graph
    return {"bit_identical": True, "replays": replays, "outputs": len(eager)}


def capture_checks(cbr, sums_ops, dihedral_ops, ce_ops, gen, host_rng) -> dict:
    """Phase 3c: each kernel alone in a captured graph at its main-path shapes,
    replayed, bit for bit against its eager launch (``captured_vs_eager``)."""
    out = {"conv_bn_relu": [], "channel_sums": [], "dihedral_normalize": [],
           "fused_cross_entropy": []}
    for b, h, w, ci, co in SLICE_SHAPES:            # the serving decoder's two launches
        x, k3, scale, shift = kernel_inputs(gen, b, h, w, ci, co, torch.bfloat16)
        res = captured_vs_eager(lambda: (cbr.conv_bn_relu(x, k3, scale, shift),))
        out["conv_bn_relu"].append({"shape": [b, h, w, ci, co], **res})
    # the train step's BatchNorm inputs, and one of 120 vectors a row
    for shape in sorted(BN_SHAPES) + [(32, 16, 16, 960)]:
        dy, x = sums_inputs(gen, shape, torch.bfloat16)
        res = captured_vs_eager(lambda: (sums_ops.channel_sums(x),
                                         sums_ops.channel_dual_sums(dy, x)))
        out["channel_sums"].append({"shape": list(shape), **res})
    images, _, masks = dihedral_case(host_rng, TRAIN_BATCH, TILE, 3, torch.uint8, False, False)
    flags = dihedral_flags(host_rng, "mixed", TRAIN_BATCH)
    for with_masks in (True, False):
        res = captured_vs_eager(lambda: tuple(t for t in dihedral_ops.dihedral_normalize(
            images, flags, masks if with_masks else None) if t is not None))
        out["dihedral_normalize"].append({"shape": [TRAIN_BATCH, TILE, TILE, 3],
                                          "masks": with_masks, **res})
    logits = (3 * torch.randn((TRAIN_BATCH, TILE, TILE, CLASSES), generator=gen,
                              device="cuda")).bfloat16()
    labels = torch.randint(0, CLASSES, logits.shape[:-1], generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)

    def ce():
        x = logits.detach().requires_grad_()
        loss = ce_ops.fused_cross_entropy(x, labels)
        return (loss.detach(), torch.autograd.grad(loss, x)[0])

    out["fused_cross_entropy"].append({"shape": list(logits.shape), "dtype": "bfloat16",
                                       "passes": "forward + backward", **captured_vs_eager(ce)})
    print(json.dumps({"capture_check": out}), flush=True)
    return out


# phase 15: the scan driver at full width; (label, step kind, S, unrolls,
# launches a step: channel_sums / channel_dual_sums / dihedral_normalize /
# fused_cross_entropy)
SCAN_CASES = [("phase1", "supervised", 4, (1, 4), (46, 46, 1, 0)),
              ("phase1_fused_ce", "supervised_fused", 4, (1, 4), (46, 46, 1, 2)),
              ("phase2", "adversarial", 2, (1,), (52, 52, 2, 0)),
              ("phase3_production", "unsupervised", 2, (1,), (211, 95, 2, 0)),
              ("grl_phase2", "grl", 2, (1,), (122, 122, 2, 0))]
CENSUS_KEYS = ("channel_sums", "channel_dual_sums", "dihedral_normalize", "fused_cross_entropy")
SCAN_EPOCHS, SCAN_ALPHAS = (20.0, 21.0), (0.5, 1.0)


def kernel_census(names) -> dict:
    """Wrapper launches implied by device kernel names: one sums kernel per
    ``channel_sums`` / ``channel_dual_sums`` call (its DUAL template flag
    tells which), one dihedral kernel per call, ``ce_fwd_kernel`` /
    ``ce_bwd_kernel`` per fused CE pass (the fold kernel rides with the
    forward), one ``conv_bn_relu`` kernel per call (not its moments fold)."""
    census = dict.fromkeys(("conv_bn_relu",) + CENSUS_KEYS, 0)
    for name in names:
        if "channel_sums_" in name and "_kernel<" in name:
            dual = "true>" in name
            if not dual and "false>" not in name:
                raise AssertionError(f"cannot tell a sums kernel's kind from {name[:120]}")
            census["channel_dual_sums" if dual else "channel_sums"] += 1
        elif "dihedral_normalize_" in name:
            census["dihedral_normalize"] += 1
        elif "ce_fwd_kernel" in name or "ce_bwd_kernel" in name:
            census["fused_cross_entropy"] += 1
        elif "conv_bn_relu" in name and "fold" not in name:
            census["conv_bn_relu"] += 1
    return census


def device_window(fn, expected=None, windows: int = 2):
    """One call of ``fn`` (already warm) under the profiler: the device events'
    names, their busy union over the host wall time of the window, and their
    summed ms.  The profiler can drop events but never adds any, so a window
    whose ``kernel_census`` is not ``expected`` is taken again, up to
    ``windows`` times, and the fullest is returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    best = None
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.events() if on_device(e)]
        if best is None or len(events) > len(best[0]):
            best = (events, wall_us)
        if expected is not None and kernel_census([e.name for e in events]) == expected:
            break
    events, wall_us = best
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    return ([e.name for e in events], union_us(spans) / wall_us if spans else None,
            sum(e - s for s, e in spans) / 1e3)


def scan_snapshot(state) -> dict:
    """Every tensor a train step updates, per ``TrainState`` of ``state``
    (parameters, buffers, Adam state, step counter): clones."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        _train_states,
    )

    snap = {}
    for i, st in enumerate(_train_states(state)):
        names = {id(p): k for k, p in st.model.named_parameters()}
        for k, v in itertools.chain(st.model.named_parameters(), st.model.named_buffers()):
            snap[f"{i}/{k}"] = v.detach().clone()
        for p, per in st.optimizer.state.items():
            snap.update({f"{i}/adam/{names[id(p)]}/{k}": v.clone() for k, v in per.items()})
        snap[f"{i}/step"] = torch.as_tensor(st.step).clone()
    return snap


def hold_scan(label, a, b, g) -> dict:
    """The scan driver's tensors ``g`` against two eager runs ``a`` and ``b`` (dicts
    of metrics and state): bit-identical wherever ``a`` and ``b`` are; where
    they differ, within their gap (the largest |a - b| of the tensor)."""
    if set(g) != set(a):
        raise AssertionError(f"{label}: the scan driver's tensors are not the eager ones")
    ident, noisy = 0, {}
    for k in a:
        if same_bits(a[k], b[k]):
            if not same_bits(g[k], a[k]):
                err = (g[k].double() - a[k].double()).abs().max().item()
                raise AssertionError(f"{label}: {k} differs from the eager steps by {err}, "
                                     "where two eager runs are bit-identical")
            ident += 1
            continue
        gap = (a[k].double() - b[k].double()).abs().max().item()
        err = (g[k].double() - a[k].double()).abs().max().item()
        noisy[k] = {"eager_gap": gap, "graph_vs_eager": err}
        if not err <= gap:
            raise AssertionError(f"{label}: {k} differs from the eager steps by {err}, "
                                 f"beyond the eager runs' own gap {gap}")
    return {"tensors": len(a), "eager_runs_bit_identical": ident,
            "graph_bit_identical": ident + sum(v["graph_vs_eager"] == 0 for v in noisy.values()),
            "within_eager_gap": noisy}


def drive_scan(counters, card, host_rng) -> dict:
    """Phase 15: ``make_scan_driver`` on the card (see main)."""
    import gc

    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        DomainAdaptationModel,
        create_discriminator,
        create_uda_model,
        create_unet,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import FineTuningLoss
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        AdversarialState,
        TrainState,
        adam,
    )

    seg0 = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                       device="cuda")
    disc0 = create_discriminator(seed=SEED + 1, dtype=torch.bfloat16, device="cuda")
    uda0 = create_uda_model(MULTI_ENCODER, classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")

    def fresh_case(kind):
        """A fresh capturable state over copies of the seeded models, and its step."""
        seg, disc = copy.deepcopy(seg0), copy.deepcopy(disc0)
        if kind.startswith("supervised"):
            return (TrainState(seg, adam(1e-4), capturable=True),
                    step_lib.make_supervised_train_step(seg, CLASSES,
                                                        fused_ce=kind.endswith("fused")))
        if kind == "adversarial":
            return (AdversarialState(TrainState(seg, adam(PROD_LR["phase2"]), capturable=True),
                                     TrainState(disc, adam(PROD_LR["phase2"]),
                                                capturable=True)),
                    step_lib.make_adversarial_train_step(seg, disc, CLASSES))
        if kind == "unsupervised":       # the production point, as phase 13 runs it
            state = TrainState(DomainAdaptationModel(seg, disc),
                               adam(PROD_LR["phase3"], clip_norm=1.0), skip_nonfinite=True,
                               capturable=True)
            return state, step_lib.make_unsupervised_sequential_step(
                seg.clone(remat="encoder", logits_dtype=torch.bfloat16), disc, CLASSES,
                FineTuningLoss(), carry_dtype=torch.bfloat16)
        model = copy.deepcopy(uda0)
        return (TrainState(model, adam(5e-5), capturable=True),
                step_lib.make_grl_sequential_step(model, CLASSES, lambda_domain=0.001))

    data_gen = torch.Generator(device="cuda").manual_seed(int(host_rng.integers(2 ** 31)))

    def stacked(kind, s):
        def u8(shape, high):       # made on the card: no host bytes to draw and copy
            return torch.randint(0, high, shape, generator=data_gen, device="cuda",
                                 dtype=torch.uint8)
        images = u8((s, TRAIN_BATCH, TILE, TILE, 3), 256)
        masks = u8((s, TRAIN_BATCH, TILE, TILE), CLASSES)
        if kind.startswith("supervised"):
            return (images, masks)
        if kind == "adversarial":
            return (images, masks, u8((s, TRAIN_BATCH, TILE, TILE, 3), 256))
        if kind == "unsupervised":
            return (images, torch.tensor(SCAN_EPOCHS[:s], dtype=torch.float32, device="cuda"))
        return (images, masks, u8((s, TRAIN_BATCH, TILE, TILE, 3), 256),
                torch.tensor(SCAN_ALPHAS[:s], dtype=torch.float32, device="cuda"))

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    results = {}
    for label, kind, s, unrolls, expected in SCAN_CASES:
        expected = dict(zip(CENSUS_KEYS, expected), conv_bn_relu=0)
        t_case = time.perf_counter()
        batches = stacked(kind, s)
        # two eager runs of S steps from the same state and generator seed
        eager = []
        for run in range(2):
            state, step = fresh_case(kind)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
            per_step, times = [], []
            for i in range(s):
                before = read_counts(counters)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                state, metrics = step(state, gen, *(b[i] for b in batches))
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                after = read_counts(counters)
                launches = {k: after[k] - before[k] for k in after}
                if launches != expected:
                    raise AssertionError(f"{label}: eager launches {launches}, expected "
                                         f"{expected}")
                per_step.append(metrics)
            tensors = {f"metric/{k}": torch.stack([m[k] for m in per_step]) for k in per_step[0]}
            tensors.update(scan_snapshot(state))
            eager.append((tensors, times))
            del state, step, per_step
            release()
        eager_times = eager[0][1][1:] + eager[1][1]       # the first step warms up
        # the eager step's device census, which checks the classifier
        state, step = fresh_case(kind)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        names, _, _ = device_window(lambda: step(state, gen, *(b[0] for b in batches)),
                                    expected)
        if kernel_census(names) != expected:
            raise AssertionError(f"{label}: eager device census {kernel_census(names)}, "
                                 f"expected {expected}")
        del state, step, names
        release()
        for unroll in unrolls:
            state, step = fresh_case(kind)
            multi = step_lib.make_scan_driver(step, unroll=unroll)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
            release()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state, metrics = multi(state, gen, *batches)
            torch.cuda.synchronize()
            first_call_s = time.perf_counter() - t0
            first_peak = torch.cuda.max_memory_allocated() - base
            (entry,) = multi.graphs.values()
            tensors = {f"metric/{k}": v for k, v in metrics.items()}
            tensors.update(scan_snapshot(state))
            held = hold_scan(f"{label} unroll {unroll}", eager[0][0], eager[1][0], tensors)
            counts = [int(st.step) for st in step_lib._train_states(state)]
            if counts != [s] * len(counts):
                raise AssertionError(f"{label}: step counters {counts} after {s} steps")
            del tensors
            # a second call: replays only
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")     # a host sync in a replay raises
            try:
                start.record()
                t0 = time.perf_counter()
                multi(state, gen, *batches)
                host_us = (time.perf_counter() - t0) * 1e6
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            end.synchronize()
            graph_ms = start.elapsed_time(end) / s
            names, busy, device_ms_call = device_window(
                lambda: multi(state, gen, *batches), {k: v * s for k, v in expected.items()})
            census = kernel_census(names)
            per_step_census = {k: v / s for k, v in census.items()}
            if per_step_census != {k: float(v) for k, v in expected.items()}:
                raise AssertionError(f"{label} unroll {unroll}: {census} device launches in "
                                     f"{s} replayed steps, expected {expected} a step")
            rec = {"steps": s, "unroll": unroll, "replays_per_call": s // unroll,
                   "eager_step_ms_p50": statistics.median(eager_times),
                   "graph_ms_per_step": graph_ms, "host_us_per_call": host_us,
                   "busy_share": busy, "device_ms_per_step": device_ms_call / s,
                   "warmup_ms": entry.warmup_s * 1e3, "capture_ms": entry.capture_s * 1e3,
                   "first_call_s": first_call_s,
                   "first_call_peak_gib": first_peak / 2 ** 30,
                   "graph_pool_gib": graph_pool_bytes(entry.graph) / 2 ** 30,
                   "launches_per_step_replayed": per_step_census, "host_syncs_in_replays": 0,
                   "held": held, "case_wall_s": time.perf_counter() - t_case, "card": card}
            results[f"{label} unroll {unroll}"] = rec
            print(f"phase 15 {label} unroll {unroll}: {json.dumps(rec)}", flush=True)
            del state, step, multi, entry, metrics
            release()
        del batches, eager
        release()
    return {"cases": results}


def graph_pool_bytes(graph) -> int:
    """Bytes of the segments the caching allocator holds for ``graph``'s
    private pool (0 when the snapshot does not say)."""
    pool = graph.pool()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


DECODER_SCHEDULES = (False, True, "dilated")


def drive_fused_decoder(counters, card, host_rng) -> dict:
    """Phase 16: the U-Net's ``fused_decoder`` schedules on the card (see main)."""
    import gc

    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
        softmax_cross_entropy,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_predict_step,
        make_scan_driver,
        make_supervised_train_step,
    )

    weights = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                          device="cuda").state_dict()
    batches = [tuple(torch.from_numpy(a).cuda() for a in b)
               for b in train_batches(host_rng, 2)]
    small = torch.from_numpy(host_rng.normal(size=(4, TILE, TILE, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(host_rng.integers(0, CLASSES, (4, TILE, TILE))).cuda()

    def model(fused_decoder, dtype=torch.bfloat16, fused_eval=False):
        m = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=dtype, device="cuda",
                        fused_decoder=fused_decoder, fused_eval=fused_eval)
        m.load_state_dict(weights, strict=True)
        return m

    def f32_run(fused_decoder):
        m = model(fused_decoder, torch.float32)
        with torch.no_grad():
            eval_logits = m(small[:2])
        m.train()
        logits = m(small)
        loss = softmax_cross_entropy(logits, labels)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        return eval_logits, logits.detach(), loss.item(), grads

    naive32 = f32_run(False)
    out = {repr(fd): {"train_step": [], "graph_ms_per_step": [], "serving_fused_eval_False": [],
                      "serving_fused_eval_True": [], "card": card} for fd in DECODER_SCHEDULES}
    # every schedule built once from the same weights, then timed in turns
    # (naive, True, "dilated", "dilated", True, naive): a run's drift falls on
    # all three alike
    def bound(step, state, gen):
        return lambda b: step(state, gen, *b)

    # the same step as S=2 CUDA graph replays (make_scan_driver): its device
    # time, without the eager step's host gaps
    stacked = [torch.stack(parts) for parts in zip(*batches)]
    train, graphs, serve = {}, {}, {}
    for fd in DECODER_SCHEDULES:
        m = model(fd)
        state = TrainState(m, adam(1e-4))
        step = make_supervised_train_step(m, CLASSES, fused_ce=True)      # WEAK
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        train[fd] = bound(step, state, gen)
        m = model(fd)
        state = TrainState(m, adam(1e-4), capturable=True)
        multi = make_scan_driver(make_supervised_train_step(m, CLASSES, fused_ce=True))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
        multi(state, gen, *stacked)                       # warm-up, capture, replays
        graphs[fd] = functools.partial(multi, state, gen, *stacked)
        for fused_eval in (False, True):
            serve[fd, fused_eval] = make_predict_step(model(fd, fused_eval=fused_eval))
    x = batches[0][0]
    for fd in DECODER_SCHEDULES + DECODER_SCHEDULES[::-1]:
        base = torch.cuda.memory_allocated()
        rec = measure_step(train[fd], batches, counters)
        if rec["launches_per_step"] != {"conv_bn_relu": 0, "channel_sums": 46,
                                        "channel_dual_sums": 46, "dihedral_normalize": 1,
                                        "fused_cross_entropy": 2}:
            raise AssertionError(f"fused_decoder={fd!r}: step launches "
                                 f"{rec['launches_per_step']}")
        rec["peak_above_resident_gib"] = rec.pop("peak_mem_gib") - base / 2 ** 30
        out[repr(fd)]["train_step"].append(rec)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graphs[fd]()
        end.record()
        end.synchronize()
        out[repr(fd)]["graph_ms_per_step"].append(start.elapsed_time(end) / len(batches))
        for fused_eval in (False, True):
            pred = serve[fd, fused_eval]
            before = read_counts(counters)
            logits = pred(x)
            torch.cuda.synchronize()
            n_cbr = read_counts(counters)["conv_bn_relu"] - before["conv_bn_relu"]
            if n_cbr != (2 if fused_eval else 0) or not torch.isfinite(logits).all():
                raise AssertionError(f"fused_decoder={fd!r} fused_eval={fused_eval}: "
                                     f"{n_cbr} conv_bn_relu launches")
            del logits
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(lambda: pred(x), reps=10)
            out[repr(fd)][f"serving_fused_eval_{fused_eval}"].append({
                "forward_ms": ms, "tiles_per_s": TRAIN_BATCH / ms * 1e3,
                "peak_above_resident_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30})
    del train, graphs, serve
    gc.collect()
    torch.cuda.empty_cache()
    for fd in DECODER_SCHEDULES[1:]:      # float32 on the card against the naive schedule
        ev, lg, loss, grads = f32_run(fd)
        torch.testing.assert_close(ev, naive32[0], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(lg, naive32[1], rtol=2e-4, atol=2e-4)
        if abs(loss - naive32[2]) > 1e-5 * abs(naive32[2]):
            raise AssertionError(f"fused_decoder={fd!r}: f32 loss {loss} vs {naive32[2]}")
        ref = naive32[3]
        num = sum((grads[k].double() - ref[k].double()).norm() ** 2 for k in ref) ** 0.5
        den = sum(ref[k].double().norm() ** 2 for k in ref) ** 0.5
        head = "segmentation_head.weight"
        head_err = ((grads[head] - ref[head]).abs().max() / ref[head].abs().max()).item()
        if not (num / den <= 3e-2 and head_err <= 1e-4):
            raise AssertionError(f"fused_decoder={fd!r}: f32 gradients rel L2 "
                                 f"{(num / den).item()}, head {head_err}")
        out[repr(fd)]["f32_vs_naive"] = {
            "eval_logits_max_abs": (ev - naive32[0]).abs().max().item(),
            "train_logits_max_abs": (lg - naive32[1]).abs().max().item(),
            "loss_rel": abs(loss - naive32[2]) / abs(naive32[2]),
            "grad_rel_l2": (num / den).item(), "head_grad_rel": head_err,
            "tolerance": "logits 2e-4, loss 1e-5, gradients 3e-2 rel L2 and 1e-4 head"}
        del ev, lg, grads
    for fd in DECODER_SCHEDULES:
        print(f"phase 16 fused_decoder={fd!r}: {json.dumps(out[repr(fd)])}", flush=True)
    return out


def _scan_child(card) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    t0 = time.perf_counter()
    scan = drive_scan(counters, card, np.random.default_rng(SEED + 15))
    scan["phase_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder = drive_fused_decoder(counters, card, np.random.default_rng(SEED + 16))
    return {"scan": scan, "fused_decoder": decoder,
            "fused_decoder_wall_s": time.perf_counter() - t0,
            "launches": read_counts(counters)}


def scan_phase(card) -> dict:
    """Phases 15 and 16 in a fresh process of their own (spawned, as phases 9-14)."""
    import multiprocessing

    torch.cuda.empty_cache()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_scan_child, (card,))


# ---------------------------------------------------------------------------
# phase 17: data parallelism across processes (parallel.distributed)
# ---------------------------------------------------------------------------
DIST_STEPS, DIST_RANKS, DIST_TIMEOUT_S = 3, 2, 600.0
DIST_LR = 1e-4
DIST_PIPE_TILE, DIST_PIPE_BATCH, DIST_PIPE_TILES, DIST_PIPE_TARGETS = 256, 8, 40, 32
# launches a step of each path (per rank in 17b): phase 1 with fused CE, phase 2,
# phase 3's production point
DIST_EXPECTED = {"channel_sums": 46, "channel_dual_sums": 46, "dihedral_normalize": 1,
                 "fused_cross_entropy": 2, "conv_bn_relu": 0}
DIST_PHASE2_EXPECTED = {**DIST_EXPECTED, "channel_sums": 52, "channel_dual_sums": 52,
                        "dihedral_normalize": 2, "fused_cross_entropy": 0}
DIST_PHASE3_EXPECTED = {**DIST_EXPECTED, "channel_sums": 211, "channel_dual_sums": 95,
                        "dihedral_normalize": 2, "fused_cross_entropy": 0}
# what the spawned ranks of 17b take from the process that spawns them
DIST_SETTINGS = ("CLASSES", "TRAIN_BATCH", "DIST_EXPECTED",
                 "DIST_PHASE2_EXPECTED", "DIST_PHASE3_EXPECTED", "DIST_PIPE_TILE",
                 "DIST_PIPE_BATCH", "DIST_TIMEOUT_S")


def host_snapshot(models, metrics) -> dict:
    """``update_snapshot`` of ``models`` and every metric, on the host."""
    return {k: v.cpu() for k, v in update_snapshot(models).items()} | {
        f"metric/{k}": v.detach().cpu() for k, v in metrics.items()}


def digest(tensors: dict) -> dict:
    """crc32 of each tensor's bytes."""
    import zlib

    return {k: zlib.crc32(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()) for k, v in tensors.items()}


def dist_phase1(dtype, gen_seed, capturable=False):
    """A fresh resnet34 U-Net (seeded) and its phase-1 step (WEAK, fused CE)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_supervised_train_step,
    )

    seg = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=dtype, device="cuda")
    state = TrainState(seg, adam(DIST_LR), capturable=capturable)
    step = make_supervised_train_step(seg, CLASSES, fused_ce=True)
    return seg, state, step, torch.Generator(device="cuda").manual_seed(gen_seed)


def collective_census(dist, steps: int) -> dict:
    """Collectives a step by kind: calls and bytes."""
    return {k: {"calls": c / steps, "bytes": b / steps}
            for k, (c, b) in sorted(dist.all_reduce_.counts.items())}


def collective_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU activity only): the
    calls and host ms (``cpu_time_total``, children included) of each op
    whose name holds an all-reduce, and the call's wall ms under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ops = {e.key: {"calls": e.count, "host_ms": e.cpu_time_total / 1e3}
           for e in prof.key_averages()
           if "allreduce" in e.key.lower().replace("_", "")}
    return {"ops": ops, "profiled_wall_ms": wall}


def time_rank_augment(host_rng) -> dict:
    """``augment_batch`` with phase 3's STRONG config (512 px, targets without
    masks) as a rank of a process group runs it: the global batch's draws
    restricted to its rows (``sample_rows``: per-row draws, so a stage
    computes on every row), against the same rows' count through the
    compacted stages in one process, and the global batch in one process;
    draws included.  CUDA-event ms, p50 of 5 after one warm-up."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
        STRONG,
        augment_batch,
        sample_rows,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 173)
    out = {}
    for n in (32, 128):
        images = torch.from_numpy(host_rng.integers(0, 256, (n, TILE, TILE, 3),
                                                    dtype=np.uint8)).cuda()
        row = {"one_process_compacted_ms": time_ms(
            lambda: augment_batch(gen, images, cfg=STRONG), reps=5, warmup=1)}
        for ranks in (2, 4):
            x = images[:n // ranks]

            def per_row():
                abc, params = sample_rows(gen, tuple(x.shape), STRONG, False, 0, ranks)
                return augment_batch(None, x, cfg=STRONG, abc=abc, params=params)

            row[f"ranks{ranks}"] = {
                "rows": x.shape[0], "rank_per_row_draws_ms": time_ms(per_row, reps=5, warmup=1),
                "compacted_ms": time_ms(lambda: augment_batch(gen, x, cfg=STRONG),
                                        reps=5, warmup=1)}
        out[f"global_batch_{n}"] = row
        del images
    torch.cuda.empty_cache()
    print(f"phase 17 augment_batch a rank (STRONG, {TILE} px): {json.dumps(out)}", flush=True)
    return out


def drive_dist_world1(counters, card, host_rng) -> dict:
    """17a: the phase-1 step through the data-parallel path under an NCCL group
    of one process, against the same steps without a group."""
    import gc
    import tempfile as _tempfile

    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import steps as step_lib

    batches = [tuple(torch.from_numpy(a).to("cuda") for a in b)
               for b in train_batches(host_rng, DIST_STEPS)]

    def run(capturable=False):
        seg, state, step, gen = dist_phase1(torch.bfloat16, SEED + 17, capturable)
        launches = []
        for b in batches:
            before = read_counts(counters)
            state, metrics = step(state, gen, *b)
            after = read_counts(counters)
            launches.append({k: after[k] - before[k] for k in after})
        torch.cuda.synchronize()
        return seg, state, step, gen, metrics, launches

    def timed(step, state, gen):
        return measure_step(lambda b: step(state, gen, *b), batches, counters)

    seg, state, step, gen, metrics, plain_launches = run()
    plain = {k: bits(v) for k, v in host_snapshot([seg], metrics).items()}
    plain_time = timed(step, state, gen)
    plain_profiled = collective_profile(lambda: step(state, gen, *batches[0]))
    del seg, state, step, gen, metrics
    gc.collect()
    torch.cuda.empty_cache()

    out = {"card": card}
    with _tempfile.TemporaryDirectory(prefix="uda_nccl_") as d:
        dist.initialize("file://" + os.path.join(d, "store"), 1, 0, device="cuda",
                        backend="nccl", timeout=DIST_TIMEOUT_S)
        try:
            dist.all_reduce_.counts.clear()
            seg, state, step, gen, metrics, launches = run()
            census = collective_census(dist, DIST_STEPS)
            grouped = {k: bits(v) for k, v in host_snapshot([seg], metrics).items()}
            if set(grouped) != set(plain):
                raise AssertionError("17a: the grouped step's tensors are not the plain one's")
            differ = [k for k in plain if not torch.equal(plain[k], grouped[k])]
            if differ:
                raise AssertionError(f"17a: {len(differ)} tensors differ under an NCCL group of "
                                     f"one process: {differ[:5]}")
            for per_step in plain_launches + launches:
                if per_step != DIST_EXPECTED:
                    raise AssertionError(f"17a: launches {per_step}, expected {DIST_EXPECTED}")
            group_time = timed(step, state, gen)
            profiled = collective_profile(lambda: step(state, gen, *batches[0]))
            del seg, state, step, gen, metrics
            gc.collect()
            torch.cuda.empty_cache()
            out.update({"bit_identical_tensors": len(plain), "collectives_per_step": census,
                        "launches_per_step": DIST_EXPECTED,
                        "plain_step_ms_p50": plain_time["bare_step_ms_p50"],
                        "nccl_step_ms_p50": group_time["bare_step_ms_p50"],
                        "nccl_host_syncs_per_step": group_time["host_syncs_per_step"],
                        "plain_step_profiled_wall_ms": plain_profiled["profiled_wall_ms"],
                        "nccl_step_collective_profile": profiled})
            # make_scan_driver over the grouped step: two eager runs of S=2 and
            # the driver's graph, bit for bit where the eager runs are
            s = 2
            eager = []
            for _ in range(2):
                seg, state, step, gen = dist_phase1(torch.bfloat16, SEED + 17, capturable=True)
                per_step = []
                for b in batches[:s]:
                    state, m = step(state, gen, *b)
                    per_step.append(m)
                tensors = {f"metric/{k}": torch.stack([m[k] for m in per_step])
                           for k in per_step[0]}
                tensors.update(scan_snapshot(state))
                eager.append(tensors)
                del seg, state, step, gen, per_step
            seg, state, step, gen = dist_phase1(torch.bfloat16, SEED + 17, capturable=True)
            multi = step_lib.make_scan_driver(step, unroll=1)
            stacked = [torch.stack([b[i] for b in batches[:s]]) for i in range(2)]
            before = read_counts(counters)
            dist.all_reduce_.counts.clear()
            state, scan_metrics = multi(state, gen, *stacked)
            torch.cuda.synchronize()
            # host-side counts: the warm-up's eager steps and the capture
            captured = collective_census(dist, 1)
            tensors = {f"metric/{k}": v for k, v in scan_metrics.items()}
            tensors.update(scan_snapshot(state))
            held = hold_scan("17a scan", eager[0], eager[1], tensors)
            (entry,) = multi.graphs.values()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            multi(state, gen, *stacked)
            end.record()
            end.synchronize()
            out["scan"] = {"steps": s, "held": held,
                           "graph_ms_per_step": start.elapsed_time(end) / s,
                           "eager_step_ms_p50": group_time["bare_step_ms_p50"],
                           "collectives_warmup_and_capture": captured,
                           "warmup_ms": entry.warmup_s * 1e3,
                           "capture_ms": entry.capture_s * 1e3}
            out["scan_launches"] = {k: v - before[k] for k, v in read_counts(counters).items()}
            del seg, state, step, gen, multi, eager
        finally:
            dist.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17a (NCCL, one process): {json.dumps(out)}", flush=True)
    return out


class WeightedTiles(InMemoryTiles):
    """``InMemoryTiles`` with ``DroneDataset.get_sampler``'s contract (class
    balance weights of the masks), so that ``pipeline._build_loaders`` takes
    it as the source dataset."""

    def __init__(self, images, masks):
        from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
            class_balance,
        )

        super().__init__(images, masks)
        counts = [np.bincount(m.reshape(-1), minlength=CLASSES) for m in masks]
        _, self.weights = class_balance([{c: int(n[c]) for c in np.nonzero(n)[0]}
                                         for n in counts], [m.size for m in masks])

    def get_sampler(self, indices=None):
        from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
            WeightedRandomSampler,
        )

        w = self.weights[list(indices)] if indices is not None else self.weights
        return WeightedRandomSampler(w / w.sum(), num_samples=len(w))


def _dist_rank(rank, d):
    """One rank of 17b (a spawned process): gloo, the card shared with the
    other rank.  Writes ``rank<r>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        DomainAdaptationModel,
        create_discriminator,
        create_unet,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import FineTuningLoss
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
    from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
        pipeline,
        steps as step_lib,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        AdversarialState,
        TrainState,
        adam,
    )

    # the trainers print a line a step: into this rank's log, shown on failure
    sys.stdout = sys.stderr = open(os.path.join(d, f"rank{rank}.log"), "w", buffering=1)
    counters = kernel_counters()
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    globals().update(inputs["settings"])
    dist.initialize("file://" + os.path.join(d, "store"), DIST_RANKS, rank,
                    local_device_ids=[0], device="cuda", backend="gloo",
                    timeout=DIST_TIMEOUT_S)
    b = TRAIN_BATCH // DIST_RANKS
    rows = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to("cuda")
            for k, v in inputs["batch"].items()}
    out = {}

    def timed_step(fn):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3, read_counts(counters)

    try:
        # f32 (TF32 off) and bf16 phase-1 steps at the global B=32
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            seg, state, step, gen = dist_phase1(dtype, SEED + 171)
            (_, metrics), ms, launches = timed_step(
                lambda: step(state, gen, rows["images"], rows["masks"]))
            snap = host_snapshot([seg], metrics)
            out[label] = {"snapshot": snap if rank == 0 else None, "digest": digest(snap),
                          "loss": metrics["loss"].item(), "ms": ms, "launches": launches}
            del seg, state, step, gen, metrics, snap
            torch.cuda.empty_cache()
        # phase 2 (the adversarial step) and phase 3's production point
        seg = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                          device="cuda")
        disc = create_discriminator(seed=SEED + 1, dtype=torch.bfloat16, device="cuda")
        state = AdversarialState(TrainState(seg, adam(PROD_LR["phase2"])),
                                 TrainState(disc, adam(PROD_LR["phase2"])))
        step = step_lib.make_adversarial_train_step(seg, disc, CLASSES)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 172)
        (_, metrics), ms, launches = timed_step(
            lambda: step(state, gen, rows["images"], rows["masks"], rows["targets"]))
        out["phase2"] = {"ms": ms, "launches": launches,
                         "finite": bool(torch.isfinite(metrics["loss"]).item()),
                         "buffers": digest({f"{i}/{k}": v for i, m in enumerate((seg, disc))
                                            for k, v in m.named_buffers()}),
                         "loss": metrics["loss"].item()}
        state = TrainState(DomainAdaptationModel(seg, disc),
                           adam(PROD_LR["phase3"], clip_norm=1.0), skip_nonfinite=True)
        step = step_lib.make_unsupervised_sequential_step(
            seg.clone(remat="encoder", logits_dtype=torch.bfloat16), disc, CLASSES,
            FineTuningLoss(), carry_dtype=torch.bfloat16)
        (_, metrics), ms, launches = timed_step(
            lambda: step(state, gen, rows["targets"], PROD_EPOCH))
        out["phase3"] = {"ms": ms, "launches": launches,
                         "finite": bool(metrics["finite"].item()),
                         "buffers": digest({f"{i}/{k}": v for i, m in enumerate((seg, disc))
                                            for k, v in m.named_buffers()}),
                         "total": metrics["total"].item()}
        del seg, disc, state, step, gen, metrics
        torch.cuda.empty_cache()

        # run_pipeline at the CLI defaults, each rank's files under its own dirs
        mine = os.path.join(d, f"rank{rank}")
        Config.IMAGE_SIZE, Config.BATCH_SIZE, Config.NUM_CLASSES = (
            DIST_PIPE_TILE, DIST_PIPE_BATCH, CLASSES)
        Config.ENCODER_NAME, Config.ENCODER_WEIGHTS, Config.DEVICE = "resnet34", None, "cuda"
        Config.LOGS_DIR = os.path.join(mine, "logs")
        Config.CHECKPOINTS_DIR = Config.CHECKPOINT_DIR = os.path.join(mine, "checkpoints")
        Config.DATA_DIR = os.path.join(mine, "data")
        Config.RESULTS_DIR = os.path.join(mine, "results")
        pipe = inputs["pipeline"]
        real_build = pipeline._build_loaders
        pipeline._build_loaders = lambda batch_size: real_build(
            batch_size, source=WeightedTiles(pipe["images"], pipe["masks"]),
            target=InMemoryTargets(pipe["targets"]))
        model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")
        reset_counts(counters)
        t0 = time.perf_counter()
        summary = pipeline.run_pipeline(1, 1, 1, force_transitions=True, model=model)
        torch.cuda.synchronize()
        files = sorted(os.path.relpath(os.path.join(root, f), mine)
                       for root, _, fs in os.walk(mine) for f in fs)
        out["pipeline"] = {"final_phase": summary["final_phase"],
                           "metrics": {k: v["metrics"] for k, v in summary["phases"].items()},
                           "model": digest(model.state_dict()),
                           "files": files, "wall_s": time.perf_counter() - t0,
                           "launches": read_counts(counters)}
        out["collectives"] = dict(dist.all_reduce_.counts)
    finally:
        dist.shutdown()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


# float32 gradients of two ranks, of each tensor's largest: against one
# process that repeats the ranks' arithmetic (BatchNorm sums of the halves
# added, each convolution on each half) and against the plain process at
# B=32, which the ranks' reassociation moves by ~6e-3 (PERF.md, PR 14)
DIST_GRAD_TOL, DIST_PLAIN_GRAD_TOL = 1e-4, 1e-2


def grad_gap(ref, got):
    """Two snapshots' gradients: the worst difference over its tensor's
    largest entry (over 1e-6 of the network's largest for a tensor below
    that) and that tensor, and the worst relative L2 difference of a tensor
    (a few flipped units give a large first number and a small second)."""
    grads = {k: ref[k] for k in ref if "/grad/" in k}
    largest = max(g.abs().max().item() for g in grads.values())
    gap, worst, rel_l2 = 0.0, None, 0.0
    for k, g in grads.items():
        diff = got[k] - g
        err = diff.abs().max().item() / max(g.abs().max().item(), 1e-6 * largest)
        if err > gap:
            gap, worst = err, k
        rel_l2 = max(rel_l2, (diff.norm() / g.norm().clamp_min(1e-6 * largest)).item())
    return gap, worst, rel_l2


def drive_dist_two_ranks(counters, card, host_rng) -> dict:
    """17b: two gloo ranks sharing the card (see main)."""
    import gc
    import multiprocessing
    import tempfile as _tempfile

    images, masks = train_batches(host_rng, 1)[0]
    targets = np.clip(host_rng.integers(0, 256, images.shape) * 0.7 + 40.0, 0,
                      255).astype(np.uint8)
    pipe = {"images": host_rng.integers(0, 256, (DIST_PIPE_TILES, DIST_PIPE_TILE,
                                                 DIST_PIPE_TILE, 3), dtype=np.uint8),
            "masks": host_rng.integers(0, CLASSES, (DIST_PIPE_TILES, DIST_PIPE_TILE,
                                                    DIST_PIPE_TILE)).astype(np.int32),
            "targets": np.clip(host_rng.integers(0, 256, (DIST_PIPE_TARGETS, DIST_PIPE_TILE,
                                                          DIST_PIPE_TILE, 3)) * 0.7 + 40.0,
                               0, 255).astype(np.uint8)}
    # the one-process references: the f32 and bf16 steps at B=32, same draws,
    # and the f32 step with the ranks' arithmetic: the BatchNorm sums of the
    # two halves added, as the all-reduce adds the ranks', and every
    # convolution run on each half (cuDNN's algorithms at B=16, the weight
    # gradient a sum of the halves', as the gradient all-reduce sums the
    # ranks'); for the gaps line, the split sums alone, and cuDNN's
    # deterministic algorithms (another choice of algorithms at B=32)
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import batch_norm

    def split_sums(fn):
        def split(*ts):
            half = ts[0].shape[0] // 2
            a, b = fn(*(t[:half] for t in ts)), fn(*(t[half:] for t in ts))
            return a[0] + b[0], a[1] + b[1]
        return split

    def halves_conv(x, *args, **kwargs):
        half = x.shape[0] // 2
        y = torch.cat([real_conv(x[:half], *args, **kwargs),
                       real_conv(x[half:], *args, **kwargs)])
        if x.is_contiguous(memory_format=torch.channels_last):
            y = y.contiguous(memory_format=torch.channels_last)
        return y

    real_sums = batch_norm.channel_sums, batch_norm.channel_dual_sums
    real_conv = torch.nn.functional.conv2d
    refs = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                         ("f32_ranks_arithmetic", torch.float32),
                         ("f32_split_sums", torch.float32),
                         ("f32_deterministic", torch.float32)):
        torch.backends.cudnn.deterministic = label == "f32_deterministic"
        if label in ("f32_ranks_arithmetic", "f32_split_sums"):
            batch_norm.channel_sums, batch_norm.channel_dual_sums = map(split_sums, real_sums)
        if label == "f32_ranks_arithmetic":
            torch.nn.functional.conv2d = halves_conv
        seg, state, step, gen = dist_phase1(dtype, SEED + 171)
        t0 = time.perf_counter()
        _, metrics = step(state, gen, torch.from_numpy(images).to("cuda"),
                          torch.from_numpy(masks).to("cuda"))
        torch.cuda.synchronize()
        refs[label] = {"snapshot": host_snapshot([seg], metrics) if dtype == torch.float32
                       else None, "loss": metrics["loss"].item(),
                       "ms": (time.perf_counter() - t0) * 1e3}
        del seg, state, step, gen, metrics
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        batch_norm.channel_sums, batch_norm.channel_dual_sums = real_sums
        torch.nn.functional.conv2d = real_conv
    plain = refs["f32"]["snapshot"]
    witness = refs.pop("f32_ranks_arithmetic")
    split = refs.pop("f32_split_sums")["snapshot"]
    gaps = {"one_process_deterministic_algorithms_vs_plain":
            grad_gap(plain, refs.pop("f32_deterministic")["snapshot"]),
            "one_process_split_sums_vs_plain": grad_gap(plain, split)}

    out = {"card": card}
    with _tempfile.TemporaryDirectory(prefix="uda_gloo_") as d:
        torch.save({"batch": {"images": images, "masks": masks, "targets": targets},
                    "pipeline": pipe, "settings": {k: globals()[k] for k in DIST_SETTINGS}},
                   os.path.join(d, "inputs.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_dist_rank, args=(r, d)) for r in range(DIST_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * DIST_RANKS:
            for r in range(DIST_RANKS):
                log = os.path.join(d, f"rank{r}.log")
                if os.path.exists(log):
                    with open(log) as f:
                        print(f"17b rank {r} log (end):\n{f.read()[-3000:]}", flush=True)
            raise AssertionError(f"17b: ranks exited with {codes} (a rank that fails or "
                                 "hangs fails the run)")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(DIST_RANKS)]
        out["ranks_wall_s"] = time.perf_counter() - t0

    a, b = ranks
    # f32: rank 0 against the one-process references; rank 1 against rank 0
    got = a["f32"]["snapshot"]
    gaps.update({"one_process_ranks_arithmetic_vs_plain": grad_gap(plain, witness["snapshot"]),
                 "two_ranks_vs_plain": grad_gap(plain, got),
                 "two_ranks_vs_split_sums": grad_gap(split, got),
                 "two_ranks_vs_ranks_arithmetic": grad_gap(witness["snapshot"], got)})
    # (worst gap of its tensor's largest, that tensor, worst relative L2)
    print(f"phase 17b f32 gradient gaps: {json.dumps(gaps)}", flush=True)
    rel = {}
    for label, ref in (("plain", refs["f32"]), ("ranks_arithmetic", witness)):
        rel[label] = abs(a["f32"]["loss"] - ref["loss"]) / abs(ref["loss"])
        if not rel[label] <= 1e-5:
            raise AssertionError(f"17b f32: loss {a['f32']['loss']} against the {label} "
                                 f"process's {ref['loss']}")
    out["f32"] = {"loss_rel_err": rel,
                  "against_ranks_arithmetic": hold_update(
                      "17b f32 against the ranks' arithmetic", witness["snapshot"], got,
                      DIST_LR, DIST_GRAD_TOL, buffer_tol=1e-5),
                  "against_plain": hold_update("17b f32 against the plain process", plain, got,
                                               DIST_LR, DIST_PLAIN_GRAD_TOL, buffer_tol=1e-5),
                  "grad_gaps": gaps}
    rel = abs(a["bf16"]["loss"] - refs["bf16"]["loss"]) / abs(refs["bf16"]["loss"])
    if not (rel <= 1e-2 and math.isfinite(a["bf16"]["loss"])):
        raise AssertionError(f"17b bf16: loss {a['bf16']['loss']} against "
                             f"{refs['bf16']['loss']}")
    out["bf16"] = {"loss_rel_err": rel}
    for label in ("f32", "bf16"):
        if a[label]["digest"] != b[label]["digest"]:
            raise AssertionError(f"17b {label}: the ranks' states differ")
    for label in ("phase2", "phase3"):
        if not (a[label]["finite"] and b[label]["finite"]):
            raise AssertionError(f"17b {label}: not finite")
        if a[label]["buffers"] != b[label]["buffers"]:
            raise AssertionError(f"17b {label}: the ranks' BatchNorm buffers differ")
    for rank in ranks:
        for label, expected in (("f32", DIST_EXPECTED), ("bf16", DIST_EXPECTED),
                                ("phase2", DIST_PHASE2_EXPECTED),
                                ("phase3", DIST_PHASE3_EXPECTED)):
            if rank[label]["launches"] != expected:
                raise AssertionError(f"17b {label}: launches {rank[label]['launches']}, "
                                     f"expected {expected}")
    pa, pb = a["pipeline"], b["pipeline"]
    if not (pa["final_phase"] == pb["final_phase"] == "FINE_TUNING"):
        raise AssertionError(f"17b pipeline: final phases {pa['final_phase']}, "
                             f"{pb['final_phase']}")
    if pa["model"] != pb["model"]:
        raise AssertionError("17b pipeline: the ranks' final weights differ")
    if pb["files"] or not pa["files"]:
        raise AssertionError(f"17b pipeline: rank 1 wrote {pb['files'][:5]}, rank 0 "
                             f"{len(pa['files'])} files")
    kinds = {os.path.basename(f).split(".")[0] for f in pa["files"]}
    if not {"best_model", "training_metadata", "events"} <= kinds:
        raise AssertionError(f"17b pipeline: rank 0 wrote {pa['files']}")
    if pa["metrics"] != pb["metrics"]:
        raise AssertionError("17b pipeline: the ranks' summaries differ")
    out.update({
        "timing_note": "two ranks share one card and gloo stages through the host: "
                       "correctness runs, not performance figures",
        "step_ms": {label: [r[label]["ms"] for r in ranks]
                    for label in ("f32", "bf16", "phase2", "phase3")},
        "one_process_step_ms": {k: v["ms"] for k, v in refs.items()},
        "launches_per_rank": {label: a[label]["launches"]
                              for label in ("f32", "bf16", "phase2", "phase3")},
        "pipeline": {"final_phase": pa["final_phase"], "wall_s": [pa["wall_s"], pb["wall_s"]],
                     "rank0_files": len(pa["files"]), "rank1_files": 0,
                     "launches_per_rank": [pa["launches"], pb["launches"]]},
        "collectives_rank0": a["collectives"]})
    launches = {k: sum(r[label]["launches"][k] for r in ranks
                       for label in ("f32", "bf16", "phase2", "phase3"))
                + sum(r["pipeline"]["launches"][k] for r in ranks) for k in DIST_EXPECTED}
    out["launches"] = launches
    print(f"phase 17b (gloo, two ranks on one card): {json.dumps(out)}", flush=True)
    return out


def _dist_child(card, path) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    t0 = time.perf_counter()
    reset_counts(counters)
    world1 = drive_dist_world1(counters, card, np.random.default_rng(SEED + 17))
    launches = read_counts(counters)
    world1["wall_s"] = time.perf_counter() - t0
    # (outside the main path's counts)
    world1["augment_a_rank"] = time_rank_augment(np.random.default_rng(SEED + 173))
    t0 = time.perf_counter()
    two = drive_dist_two_ranks(counters, card, np.random.default_rng(SEED + 171))
    two["wall_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump({"nccl_world1": world1, "gloo_two_ranks": two,
                   "launches": {k: launches[k] + two["launches"].get(k, 0) for k in launches}},
                  f)


def dist_phase(card) -> dict:
    """Phase 17 in a fresh process of its own (spawned, as phases 9-16, but not
    a pool's daemon: it spawns the two ranks of 17b).  A child that fails or
    does not finish in time fails the run."""
    import multiprocessing
    import tempfile as _tempfile

    torch.cuda.empty_cache()
    with _tempfile.TemporaryDirectory(prefix="uda_phase17_") as d:
        path = os.path.join(d, "result.json")
        child = multiprocessing.get_context("spawn").Process(target=_dist_child,
                                                             args=(card, path))
        child.start()
        child.join(3 * DIST_TIMEOUT_S)
        if child.is_alive():
            child.kill()
            child.join()
        if child.exitcode != 0:
            raise AssertionError(f"phase 17: its process exited with {child.exitcode}")
        with open(path) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# 18. the height-sharded forward (parallel.spatial) across four gloo ranks
# ---------------------------------------------------------------------------
SPATIAL_RANKS, SPATIAL_TIMEOUT_S = 4, 300.0
# (label, mesh (n_data, n_space), global batch, tile px, dtype, fused_decoder)
SPATIAL_CASES = (("bf16_4096_mesh1x4", (1, 4), 1, 4096, "bfloat16", "auto"),
                 ("bf16_2048_mesh2x2", (2, 2), 2, 2048, "bfloat16", "auto"),
                 ("f32_512_mesh1x4", (1, 4), 2, 512, "float32", "auto"),
                 ("f32_512_mesh2x2", (2, 2), 2, 512, "float32", "auto"),
                 ("f32_32_mesh1x4", (1, 4), 2, 32, "float32", "auto"),
                 ("f32_512_dilated_mesh1x4", (1, 4), 2, 512, "float32", "dilated"))
SPATIAL_BF16_TOL = 2e-2              # of the largest |logit|, against the plain forward
SPATIAL_F32_TOL = 1e-5               # the JAX test's bound
# bf16 argmax against the plain forward: the one-process witness of the ranks'
# row blocks, which the blocks equal bit for bit, reads 99.648% there at
# (2, 2) too: cuDNN's bf16 algorithms at the ranks' shapes (PERF.md)
SPATIAL_ARGMAX_AGREEMENT = 0.995
SPATIAL_SETTINGS = ("CLASSES", "SPATIAL_RANKS", "SPATIAL_TIMEOUT_S", "SPATIAL_CASES")


def spatial_tile(case_index: int, b: int, size: int) -> np.ndarray:
    """The case's normalized float32 tile (ImageNet statistics), made from a
    seed on every rank alike: the full host value ``spatial_forward`` takes."""
    rng = np.random.default_rng(SEED + 180 + case_index)
    x = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8).astype(np.float32) / 255.0
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    return (x - mean) / std


def row_block_conv2d(n_space):
    """``F.conv2d`` that computes its output as ``n_space`` row blocks, each
    from its input rows plus the halo rows a rank fetches (zeros beyond the
    edges), as a channels_last tensor of that shape: the ranks' arithmetic in
    one process.  A level the ranks compute whole (rows not divisible, or an
    odd block into a stride-2 layer) is computed whole."""
    from torch.nn.modules.utils import _pair

    real = F.conv2d

    def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        kh, (sh, _), (ph, pw), (dh, _) = (weight.shape[2], _pair(stride), _pair(padding),
                                          _pair(dilation))
        h = x.shape[2] // n_space
        if x.shape[2] % n_space or (sh == 2 and h % 2):
            return real(x, weight, bias, stride, padding, dilation, groups)
        above, below = ph, (dh * (kh - 1) - ph if sh == 1 else max(0, kh - ph - 2))
        xp = F.pad(x, (0, 0, above, below))
        blocks = [real(xp[:, :, s * h:s * h + h + above + below].contiguous(
            memory_format=torch.channels_last), weight, bias, stride, (0, pw), dilation,
            groups) for s in range(n_space)]
        return torch.cat(blocks, 2)

    return conv2d


class KernelCalls:
    """Stands in for ``models.unet``'s ``conv_bn_relu`` (the counted wrapper,
    called through) and keeps the inputs and output of each launch while
    ``recording``; :meth:`check` gives each one's largest gap to
    ``conv_bn_relu_reference`` on the same inputs and whether it is within
    phase 3's tolerance (``TOL``, atol and rtol as ``assert_close``)."""

    def __init__(self, real):
        self.real, self.recording, self.calls = real, False, []

    def __call__(self, x, k3, scale=None, shift=None, **kwargs):
        y = self.real(x, k3, scale, shift, **kwargs)
        if self.recording:
            self.calls.append((x, k3, scale, shift, y))
        return y

    def check(self):
        from uda_aerial_semantic_segmentation_research_tpu_torch.ops.conv_bn_relu import (
            conv_bn_relu_reference,
        )

        out = []
        for x, k3, scale, shift, y in self.calls:
            y, ref = y.float(), conv_bn_relu_reference(x, k3, scale, shift).float()
            tol = TOL[x.dtype]
            out.append({"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
                        "max_abs_err": (y - ref).abs().max().item(),
                        "within": bool(((y - ref).abs() <= tol + tol * ref.abs()).all())})
        self.calls = []
        return out


def _spatial_rank(rank, d):
    """One rank of phase 18 (a spawned process): gloo, the card shared with
    the other ranks.  Writes ``rank<r>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import unet as unet_module
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import Conv2d
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

    sys.stdout = sys.stderr = open(os.path.join(d, f"rank{rank}.log"), "w", buffering=1)
    real_conv2d = F.conv2d
    settings = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)["settings"]
    globals().update(settings)
    counters = kernel_counters()
    dist.initialize("file://" + os.path.join(d, "store"), SPATIAL_RANKS, rank,
                    local_device_ids=[0], device="cuda", backend="gloo",
                    timeout=SPATIAL_TIMEOUT_S)
    out = {}
    kernel_calls = unet_module.conv_bn_relu = KernelCalls(unet_module.conv_bn_relu)
    try:
        # every process creates every space group, in the same order
        meshes = {shape: spatial.spatial_mesh(*shape)
                  for shape in dict.fromkeys(c[1] for c in SPATIAL_CASES)}
        models = {}
        for dtype_name in ("bfloat16", "float32"):
            net = create_unet("resnet34", classes=CLASSES, seed=SEED,
                              dtype=getattr(torch, dtype_name), device="cuda", fused_eval=True)
            randomize_batch_norms_(net, torch.Generator().manual_seed(SEED))
            models[dtype_name] = net
        window_convs = sum(isinstance(m, Conv2d) and m.kernel_size[0] > 1
                           for m in models["float32"].modules())
        for i, (label, shape, batch, size, dtype_name, fused_decoder) in enumerate(
                SPATIAL_CASES):
            mesh = meshes[shape]
            net = models[dtype_name]
            module = net if fused_decoder == "auto" else net.clone(fused_decoder=fused_decoder)
            x = spatial_tile(i, batch, size)
            rows_b, rows_h = spatial.spatial_image_sharding(mesh).block(x.shape)
            torch.cuda.synchronize()
            reset_counts(counters)
            dist.all_reduce_.counts.clear()
            kernel_calls.recording = True
            t0 = time.perf_counter()
            block = spatial.spatial_forward(module, None, x, mesh)
            torch.cuda.synchronize()
            sharded_ms = (time.perf_counter() - t0) * 1e3
            kernel_calls.recording = False
            launches = read_counts(counters)
            collectives = {k: list(v) for k, v in dist.all_reduce_.counts.items()}
            # each launch of the sharded forward (the rank's rows with the
            # neighbours' attached) against the kernel's plain version
            kernel_checks = kernel_calls.check()
            # the unsharded forward of the naive module, in this process
            # alone, of the images this rank holds: the reference
            t0 = time.perf_counter()
            with torch.inference_mode():
                ref = net(torch.from_numpy(x[rows_b]).to("cuda"))
            torch.cuda.synchronize()
            whole_ms = (time.perf_counter() - t0) * 1e3
            with torch.inference_mode():
                # the witness: the same forward with every conv in the ranks'
                # row blocks and halos (cuDNN's algorithms at their shapes)
                F.conv2d = row_block_conv2d(mesh.n_space)
                try:
                    witness = net(torch.from_numpy(x[rows_b]).to("cuda"))[:, rows_h].float()
                finally:
                    F.conv2d = real_conv2d
            own, got = ref[:, rows_h].float(), block.float()
            largest = ref.float().abs().max().item()
            err = (got - own).abs().max().item()

            def agreement(a, b):
                return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

            out[label] = {
                "device": str(block.device), "dtype": str(block.dtype),
                "shape": list(block.shape), "coords": [mesh.data_index, mesh.space_index],
                "max_abs_err": err, "largest_abs_logit": largest, "rel_err": err / largest,
                "argmax_agreement": agreement(got, own),
                "witness": {
                    "max_abs_err": (got - witness).abs().max().item(),
                    "rel_err": (got - witness).abs().max().item() / largest,
                    "argmax_agreement": agreement(got, witness),
                    "witness_vs_whole_rel_err": (witness - own).abs().max().item() / largest,
                    "witness_vs_whole_argmax_agreement": agreement(witness, own)},
                "finite": bool(torch.isfinite(got).all().item()),
                "launches": launches, "collectives": collectives,
                "kernel_checks": kernel_checks,
                "sharded_ms": sharded_ms, "whole_ms": whole_ms,
                "levels_split": spatial.Shard(mesh, size, size, 3).split,
                "window_layers": window_convs + 1}
            del block, ref, own, got, witness
            torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        unet_module.conv_bn_relu = kernel_calls.real
        dist.shutdown()


def _spawn_spatial_ranks(target, settings, tag) -> list:
    """``target(rank, d)`` in ``SPATIAL_RANKS`` spawned processes that meet in
    a temporary directory ``d`` holding ``inputs.pt`` (``settings``, the
    module globals the ranks take over); each writes ``rank<r>.pt`` and its
    log.  A rank that fails or does not finish in time fails the run, its
    log printed.  Returns the ranks' results and their wall time."""
    import multiprocessing
    import tempfile as _tempfile

    with _tempfile.TemporaryDirectory(prefix="uda_spatial_") as d:
        torch.save({"settings": {k: globals()[k] for k in settings}},
                   os.path.join(d, "inputs.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=target, args=(r, d)) for r in range(SPATIAL_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPATIAL_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * SPATIAL_RANKS:
            for r in range(SPATIAL_RANKS):
                log = os.path.join(d, f"rank{r}.log")
                if os.path.exists(log):
                    with open(log) as f:
                        print(f"{tag} rank {r} log (end):\n{f.read()[-3000:]}", flush=True)
            raise AssertionError(f"{tag}: ranks exited with {codes} (a rank that fails or "
                                 "hangs fails the run)")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(SPATIAL_RANKS)]
        return ranks, time.perf_counter() - t0


def drive_spatial(card) -> dict:
    """Phase 18: four gloo ranks sharing the card run ``spatial_forward``
    (see main); the checks come after a line of the gaps."""
    out = {"card": card, "timing_note": "four ranks share one card and gloo stages "
           "through the host: correctness runs, not performance figures"}
    ranks, out["ranks_wall_s"] = _spawn_spatial_ranks(_spatial_rank, SPATIAL_SETTINGS, "18")
    labels = [c[0] for c in SPATIAL_CASES]
    gaps = {label: {"rel_err": max(r[label]["rel_err"] for r in ranks),
                    "max_abs_err": max(r[label]["max_abs_err"] for r in ranks),
                    "largest_abs_logit": ranks[0][label]["largest_abs_logit"],
                    "argmax_agreement": min(r[label]["argmax_agreement"] for r in ranks),
                    "against_the_ranks_arithmetic": {
                        k: (min if "agreement" in k else max)(r[label]["witness"][k]
                                                              for r in ranks)
                        for k in ranks[0][label]["witness"]},
                    "conv_bn_relu_max_abs_err": [
                        max(r[label]["kernel_checks"][i]["max_abs_err"] for r in ranks)
                        for i in range(len(ranks[0][label]["kernel_checks"]))]}
            for label in labels}
    print(f"phase 18 gaps (sharded against the whole forward, worst rank): "
          f"{json.dumps(gaps)}", flush=True)
    launches = {k: 0 for k in ranks[0][labels[0]]["launches"]}
    for label, shape, batch, size, dtype_name, _ in SPATIAL_CASES:
        n_data, n_space = shape
        for r in ranks:
            res = r[label]
            expected_shape = [batch // n_data, size // n_space, size, CLASSES]
            if res["shape"] != expected_shape or not res["device"].startswith("cuda"):
                raise AssertionError(f"18 {label}: block {res['shape']} on {res['device']}, "
                                     f"expected {expected_shape} on the card")
            if not res["finite"]:
                raise AssertionError(f"18 {label}: non-finite logits")
            if res["launches"] != {**{k: 0 for k in res["launches"]}, "conv_bn_relu": 2}:
                raise AssertionError(f"18 {label}: launches {res['launches']}, expected 2 "
                                     "conv_bn_relu and nothing else")
            bad = [c for c in res["kernel_checks"] if not c["within"]]
            if bad:
                raise AssertionError(f"18 {label}: conv_bn_relu against its plain version "
                                     f"beyond {TOL[getattr(torch, dtype_name)]} (atol and "
                                     f"rtol) at {bad}")
            if res["collectives"] != ranks[0][label]["collectives"]:
                raise AssertionError(f"18 {label}: the ranks' exchanges differ")
            if all(res["levels_split"]) and res["collectives"] != {
                    "halo": [res["window_layers"], res["collectives"]["halo"][1]]}:
                raise AssertionError(f"18 {label}: {res['collectives']}, expected one halo "
                                     f"exchange for each of {res['window_layers']} window layers")
            for k, v in res["launches"].items():
                launches[k] += v
        tol = SPATIAL_F32_TOL if dtype_name == "float32" else SPATIAL_BF16_TOL
        if not gaps[label]["rel_err"] <= tol:
            raise AssertionError(f"18 {label}: sharded against the whole forward "
                                 f"{gaps[label]['rel_err']} of the largest |logit|, bound {tol}")
        witness_err = gaps[label]["against_the_ranks_arithmetic"]["max_abs_err"]
        if witness_err != 0.0:
            raise AssertionError(f"18 {label}: sharded against the ranks' arithmetic "
                                 f"{witness_err}, expected bit for bit")
        if dtype_name == "bfloat16" and not (
                gaps[label]["argmax_agreement"] >= SPATIAL_ARGMAX_AGREEMENT):
            raise AssertionError(f"18 {label}: argmax agrees with the whole forward on "
                                 f"{gaps[label]['argmax_agreement']}, bound "
                                 f"{SPATIAL_ARGMAX_AGREEMENT}")
    out["cases"] = {label: {
        "gaps": gaps[label], "levels_split": ranks[0][label]["levels_split"],
        "collectives_per_rank": ranks[0][label]["collectives"],
        "conv_bn_relu_per_rank": ranks[0][label]["launches"]["conv_bn_relu"],
        "sharded_ms": [r[label]["sharded_ms"] for r in ranks],
        "whole_ms_one_process": [r[label]["whole_ms"] for r in ranks]} for label in labels}
    out["peak_gib_per_rank"] = [r["peak_gib"] for r in ranks]
    out["launches"] = launches
    print(f"phase 18 (spatial_forward, four gloo ranks on one card): {json.dumps(out)}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# 18b. the other segmentation models' height-sharded forward, four gloo ranks
# ---------------------------------------------------------------------------
# (create_model name, or "UDA" for create_uda_model; encoder)
FAMILY_SPATIAL_MODELS = (("FPN", "resnet34"), ("PSPNet", "resnet34"), ("Linknet", "resnet34"),
                         ("UnetPlusPlus", "resnet34"), ("DeepLabV3Plus", "resnet34"),
                         ("PAN", "resnet34"), ("MAnet", "resnet34"),
                         ("DeepLabV3Plus", "mobilenet_v2"), ("UDA", "resnet50"))
# (label, mesh (n_data, n_space), global batch, tile px, dtype)
FAMILY_SPATIAL_CASES = (("f32_512_mesh1x4", (1, 4), 2, 512, "float32"),
                        ("f32_512_mesh2x2", (2, 2), 2, 512, "float32"),
                        ("f32_64_mesh1x4", (1, 4), 2, 64, "float32"),
                        ("bf16_2048_mesh1x4", (1, 4), 1, 2048, "bfloat16"))
FAMILY_SPATIAL_SETTINGS = ("CLASSES", "SPATIAL_RANKS", "SPATIAL_TIMEOUT_S",
                           "FAMILY_SPATIAL_MODELS", "FAMILY_SPATIAL_CASES")


def family_model(name, encoder, dtype, device):
    """A seeded model of phase 18b with randomized BatchNorm statistics."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_model,
        create_uda_model,
    )

    if name == "UDA":
        net = create_uda_model(encoder, classes=CLASSES, seed=SEED, dtype=dtype, device=device)
    else:
        net = create_model(name, encoder, None, 3, CLASSES, seed=SEED, dtype=dtype,
                           device=device)
    randomize_batch_norms_(net, torch.Generator().manual_seed(SEED))
    return net


def family_label(name, encoder) -> str:
    return name if encoder == "resnet34" else f"{name}_{encoder}"


def family_witness(net, x, n_space):
    """The unsharded forward of ``x`` with every convolution computed as the
    ranks' ``n_space`` row blocks with their halos (``row_block_conv2d``),
    but inside ``spatial.whole``, which the ranks run on the whole level:
    the ranks' arithmetic in one process (their means and resizes are the
    whole forward's but for the order of the means' float32 sums)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

    real_conv2d, real_whole = F.conv2d, spatial.whole

    def whole(fn, t):
        blocks, F.conv2d = F.conv2d, real_conv2d
        try:
            return fn(t)
        finally:
            F.conv2d = blocks

    with torch.inference_mode():
        F.conv2d, spatial.whole = row_block_conv2d(n_space), whole
        try:
            return net(torch.from_numpy(x).to("cuda")).float()
        finally:
            F.conv2d, spatial.whole = real_conv2d, real_whole


def _family_spatial_rank(rank, d):
    """One rank of phase 18b (a spawned process): gloo, the card shared with
    the other ranks.  Writes ``rank<r>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import distributed as dist
    from uda_aerial_semantic_segmentation_research_tpu_torch.parallel import spatial

    sys.stdout = sys.stderr = open(os.path.join(d, f"rank{rank}.log"), "w", buffering=1)
    settings = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)["settings"]
    globals().update(settings)
    counters = kernel_counters()
    dist.initialize("file://" + os.path.join(d, "store"), SPATIAL_RANKS, rank,
                    local_device_ids=[0], device="cuda", backend="gloo",
                    timeout=SPATIAL_TIMEOUT_S)
    out = {}
    try:
        # every process creates every space group, in the same order
        meshes = {shape: spatial.spatial_mesh(*shape)
                  for shape in dict.fromkeys(c[1] for c in FAMILY_SPATIAL_CASES)}
        for name, encoder in FAMILY_SPATIAL_MODELS:
            res = out[family_label(name, encoder)] = {}
            for dtype_name in ("float32", "bfloat16"):
                net = family_model(name, encoder, getattr(torch, dtype_name), "cuda")
                for i, (label, shape, batch, size, case_dtype) in enumerate(
                        FAMILY_SPATIAL_CASES):
                    if case_dtype != dtype_name:
                        continue
                    mesh = meshes[shape]
                    x = spatial_tile(100 + i, batch, size)
                    rows_b, rows_h = spatial.spatial_image_sharding(mesh).block(x.shape)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts(counters)
                    dist.all_reduce_.counts.clear()
                    t0 = time.perf_counter()
                    block = spatial.spatial_forward(net, None, x, mesh)
                    torch.cuda.synchronize()
                    sharded_ms = (time.perf_counter() - t0) * 1e3
                    sharded_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    launches = read_counts(counters)
                    collectives = {k: list(v) for k, v in dist.all_reduce_.counts.items()}
                    # the unsharded forward of the rank's images, in this
                    # process alone: the reference
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    with torch.inference_mode():
                        ref = net(torch.from_numpy(x[rows_b]).to("cuda"))
                    torch.cuda.synchronize()
                    whole_ms = (time.perf_counter() - t0) * 1e3
                    whole_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    own, got = ref[:, rows_h].float(), block.float()
                    largest = ref.float().abs().max().item()
                    err = (got - own).abs().max().item()
                    witness = (family_witness(net, x[rows_b], mesh.n_space)[:, rows_h]
                               if dtype_name == "bfloat16" else None)
                    res[label] = {
                        "device": str(block.device), "shape": list(block.shape),
                        "max_abs_err": err, "largest_abs_logit": largest,
                        "rel_err": err / largest,
                        "argmax_agreement": (got.argmax(-1) == own.argmax(-1)).float()
                        .mean().item(),
                        "finite": bool(torch.isfinite(got).all().item()),
                        "launches": launches, "collectives": collectives,
                        "sharded_ms": sharded_ms, "whole_ms": whole_ms,
                        "sharded_peak_gib": sharded_peak, "whole_peak_gib": whole_peak,
                        "levels_split": spatial.Shard(mesh, size, size, 3).split}
                    if witness is not None:
                        res[label]["witness"] = {
                            "max_abs_err": (got - witness).abs().max().item(),
                            "argmax_agreement": (got.argmax(-1) == witness.argmax(-1)).float()
                            .mean().item(),
                            "witness_vs_whole_rel_err": (witness - own).abs().max().item()
                            / largest,
                            "witness_vs_whole_argmax_agreement": (
                                witness.argmax(-1) == own.argmax(-1)).float().mean().item()}
                    del block, ref, own, got, witness
                del net
                torch.cuda.empty_cache()
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def drive_family_spatial(card) -> dict:
    """Phase 18b: four gloo ranks sharing the card run ``spatial_forward`` of
    the other segmentation models (see main); the gaps line and the
    ``phase 18b`` line come before the checks."""
    out = {"card": card, "timing_note": "four ranks share one card and gloo stages "
           "through the host: correctness runs, not performance figures"}
    ranks, out["ranks_wall_s"] = _spawn_spatial_ranks(_family_spatial_rank,
                                                      FAMILY_SPATIAL_SETTINGS, "18b")
    models = [family_label(*m) for m in FAMILY_SPATIAL_MODELS]
    gaps = {m: {c[0]: {"rel_err": max(r[m][c[0]]["rel_err"] for r in ranks),
                       "max_abs_err": max(r[m][c[0]]["max_abs_err"] for r in ranks),
                       "largest_abs_logit": max(r[m][c[0]]["largest_abs_logit"]
                                                for r in ranks),
                       "argmax_agreement": min(r[m][c[0]]["argmax_agreement"]
                                               for r in ranks),
                       **({"against_the_ranks_arithmetic": {
                           k: (min if "agreement" in k else max)(r[m][c[0]]["witness"][k]
                                                                 for r in ranks)
                           for k in ranks[0][m][c[0]]["witness"]}}
                          if "witness" in ranks[0][m][c[0]] else {})}
                for c in FAMILY_SPATIAL_CASES} for m in models}
    print(f"phase 18b gaps (sharded against the whole forward, worst rank): "
          f"{json.dumps(gaps)}", flush=True)
    out["models"] = {m: {label: {
        "levels_split": ranks[0][m][label]["levels_split"],
        "collectives_per_rank": ranks[0][m][label]["collectives"],
        "sharded_peak_gib": [r[m][label]["sharded_peak_gib"] for r in ranks],
        "whole_peak_gib": [r[m][label]["whole_peak_gib"] for r in ranks],
        "sharded_ms": [r[m][label]["sharded_ms"] for r in ranks],
        "whole_ms_one_process": [r[m][label]["whole_ms"] for r in ranks]}
        for label, *_ in FAMILY_SPATIAL_CASES} for m in models}
    print(f"phase 18b (spatial_forward of the other models, four gloo ranks on one card): "
          f"{json.dumps(out)}", flush=True)
    launches = {k: 0 for k in ranks[0][models[0]][FAMILY_SPATIAL_CASES[0][0]]["launches"]}
    for m in models:
        for label, shape, batch, size, dtype_name in FAMILY_SPATIAL_CASES:
            n_data, n_space = shape
            expected_shape = [batch // n_data, size // n_space, size, CLASSES]
            for r in ranks:
                res = r[m][label]
                if res["shape"] != expected_shape or not res["device"].startswith("cuda"):
                    raise AssertionError(f"18b {m} {label}: block {res['shape']} on "
                                         f"{res['device']}, expected {expected_shape} on "
                                         "the card")
                if not res["finite"]:
                    raise AssertionError(f"18b {m} {label}: non-finite logits")
                if any(res["launches"].values()):
                    raise AssertionError(f"18b {m} {label}: launches {res['launches']}, "
                                         "expected none")
                if res["collectives"] != ranks[0][m][label]["collectives"]:
                    raise AssertionError(f"18b {m} {label}: the ranks' exchanges differ")
                for k, v in res["launches"].items():
                    launches[k] += v
            gap = gaps[m][label]
            tol = SPATIAL_F32_TOL if dtype_name == "float32" else SPATIAL_BF16_TOL
            if not gap["rel_err"] <= tol:
                raise AssertionError(f"18b {m} {label}: sharded against the whole forward "
                                     f"{gap['rel_err']} of the largest |logit|, bound {tol}")
            if dtype_name == "bfloat16":
                # the ranks' arithmetic in one process: bit for bit, so the
                # gap to the plain forward is cuDNN's bf16 convs at the ranks'
                # shapes, whose argmax against the plain forward is reported
                witness = gap["against_the_ranks_arithmetic"]
                if witness["max_abs_err"] != 0.0:
                    raise AssertionError(f"18b {m} {label}: sharded against the ranks' "
                                         f"arithmetic {witness['max_abs_err']}, expected bit "
                                         "for bit")
                if not witness["argmax_agreement"] >= SPATIAL_ARGMAX_AGREEMENT:
                    raise AssertionError(f"18b {m} {label}: argmax agrees with the ranks' "
                                         f"arithmetic on {witness['argmax_agreement']}, "
                                         f"bound {SPATIAL_ARGMAX_AGREEMENT}")
    out["launches"] = launches
    return out


def _spatial_child(card, path, drive) -> None:
    t0 = time.perf_counter()
    result = drive(card)
    result["wall_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(result, f)


def spatial_phase(card, drive=drive_spatial, tag="phase 18") -> dict:
    """Phase 18 (or 18b: ``drive_family_spatial``) in a fresh process of its
    own (not a pool's daemon: it spawns the four ranks).  A child that fails
    or does not finish in time fails the run."""
    import multiprocessing
    import tempfile as _tempfile

    torch.cuda.empty_cache()
    with _tempfile.TemporaryDirectory(prefix="uda_phase18_") as d:
        path = os.path.join(d, "result.json")
        child = multiprocessing.get_context("spawn").Process(target=_spatial_child,
                                                             args=(card, path, drive))
        child.start()
        child.join(2 * SPATIAL_TIMEOUT_S)
        if child.is_alive():
            child.kill()
            child.join()
        if child.exitcode != 0:
            raise AssertionError(f"{tag}: its process exited with {child.exitcode}")
        with open(path) as f:
            return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--probe-batch", type=int, default=None,
                        help="only run train steps at this batch size and report "
                             "whether they fit in device memory")
    parser.add_argument("--compare-sums-source", default=None, metavar="CU_FILE",
                        help="only time the channel_sums kernels against the ones "
                             "built from this (older) channel_sums.cu, planned by the "
                             "ops/channel_sums.py of the same commit copied beside it "
                             "(same name, .py), at the BatchNorm shapes of the resnet34 "
                             "step, the mobilenet_v2 U-Net, DeepLabV3Plus, resnet50 and "
                             "the discriminators")
    parser.add_argument("--compare-dihedral-source", default=None, metavar="CU_FILE",
                        help="only time the dihedral_normalize kernel against the one "
                             "built from this (older) source, at the train step's shape")
    parser.add_argument("--only-scan", action="store_true",
                        help="only the kernels' capture checks (3c) and phases 15-16")
    parser.add_argument("--only-dist", action="store_true",
                        help="only phase 17 (data parallelism across processes)")
    parser.add_argument("--only-spatial", action="store_true",
                        help="only phases 18 and 18b (the height-sharded forward across "
                             "processes)")
    args = parser.parse_args(argv)
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from uda_aerial_semantic_segmentation_research_tpu_torch.data.tiling import (
        tile_grid,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
        predict_batch,
        predict_raster,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
        _build,
        augment,
        channel_sums as sums_ops,
        dihedral as dihedral_ops,
        fused_ce as ce_ops,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops import conv_bn_relu as cbr
    from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
        BatchNorm,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
        make_eval_step,
        make_predict_step,
        make_supervised_train_step,
    )

    conv_bn_relu, reference = cbr.conv_bn_relu, cbr.conv_bn_relu_reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind}", flush=True)

    # 2. build: one nvcc per source, all started together
    libraries = ("conv_bn_relu", "channel_sums", "dihedral_normalize", "fused_cross_entropy")
    t0 = time.perf_counter()
    _build.build_libraries(libraries)
    for module in (cbr, sums_ops, dihedral_ops, ce_ops):
        module._library()
    print("build: " + ", ".join(f"{n} nvcc {_build.build_seconds[n]:.1f} s" for n in libraries)
          + f"; all built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.probe_batch is not None:
        return probe_batch(args.probe_batch)
    if args.compare_sums_source is not None:
        compare_sums_with_parent(sums_ops, args.compare_sums_source, card)
        print(card_line())
        return 0
    if args.compare_dihedral_source is not None:
        compare_dihedral_with_parent(dihedral_ops, args.compare_dihedral_source, card)
        print(card_line())
        return 0
    counters = kernel_counters()
    if args.only_dist:
        t0 = time.perf_counter()
        dist_result = dist_phase(card)
        dist_result["process_wall_s"] = time.perf_counter() - t0
        print(json.dumps({"dist": dist_result}), flush=True)
        print(card_line())
        return 0
    if args.only_spatial:
        t0 = time.perf_counter()
        spatial_result = spatial_phase(card)
        spatial_result["process_wall_s"] = time.perf_counter() - t0
        print(json.dumps({"spatial": spatial_result}), flush=True)
        t0 = time.perf_counter()
        family_result = spatial_phase(card, drive_family_spatial, "phase 18b")
        family_result["process_wall_s"] = time.perf_counter() - t0
        print(json.dumps({"spatial_families": family_result}), flush=True)
        print(card_line())
        return 0
    if args.only_scan:
        capture_checks(cbr, sums_ops, dihedral_ops, ce_ops,
                       torch.Generator(device="cuda").manual_seed(SEED),
                       np.random.default_rng(SEED))
        t0 = time.perf_counter()
        scan_result = scan_phase(card)
        print(json.dumps({"scan": scan_result["scan"], "process_wall_s":
                          time.perf_counter() - t0}), flush=True)
        print(json.dumps({"fused_decoder": scan_result["fused_decoder"]}), flush=True)
        print(card_line())
        return 0

    # 3a. conv_bn_relu vs plain version on the card
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for shape in SLICE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for affine in (True, False):
                results.append(check_kernel(conv_bn_relu, reference, gen, shape,
                                            dtype, affine, timed=True))
    for shape in [RAGGED_SHAPE] + EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            results.append(check_kernel(conv_bn_relu, reference, gen, shape,
                                        dtype, True, timed=False))
    path_cases = [r for r in results
                  if r["dtype"] == "bfloat16" and r["affine"] and "kernel_ms" in r]
    assert len(path_cases) == len(SLICE_SHAPES)

    # 4. the serving path: resnet34 U-Net, 23 classes, 512 px, bf16
    host_rng = np.random.default_rng(SEED)
    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda", fused_eval=True)
    randomize_batch_norms_(model, torch.Generator().manual_seed(SEED))
    batch = host_rng.integers(0, 256, (32, TILE, TILE, 3), dtype=np.uint8)
    raster = host_rng.integers(0, 256, (1500, 2000, 3), dtype=np.uint8)
    n_raster_tiles = len(tile_grid(1500, 2000, TILE, 64))
    raster_forwards = -(-n_raster_tiles // 8)

    reset_counts(counters)
    preds = predict_batch(model, batch)
    torch.cuda.synchronize()
    batch_launches = conv_bn_relu.launches
    label_map = predict_raster(model, raster, tile=TILE, overlap=64, batch_size=8)
    torch.cuda.synchronize()
    serving_counts = read_counts(counters)
    launches = serving_counts["conv_bn_relu"]
    print(f"main path (serving): predict_batch launches {batch_launches}, predict_raster "
          f"launches {launches - batch_launches} over {raster_forwards} forwards "
          f"({n_raster_tiles} tiles)", flush=True)
    if batch_launches != 2 or launches - batch_launches != 2 * raster_forwards:
        raise AssertionError("the kernel did not run exactly twice per forward")
    if preds.shape != (32, TILE, TILE) or preds.dtype != np.int32:
        raise AssertionError(f"predict_batch gave {preds.shape} {preds.dtype}")
    if label_map.shape != (1500, 2000) or label_map.dtype != np.int32:
        raise AssertionError(f"predict_raster gave {label_map.shape} {label_map.dtype}")
    for labels in (preds, label_map):
        if labels.min() < 0 or labels.max() >= CLASSES:
            raise AssertionError("labels out of range")

    step = make_predict_step(model)
    batch_dev = torch.from_numpy(batch).cuda()
    logits = step(batch_dev)
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (32, TILE, TILE, CLASSES):
        raise AssertionError("bf16 logits not finite or of the wrong shape")
    torch.cuda.reset_peak_memory_stats()
    forward_ms = time_ms(lambda: step(batch_dev), reps=10)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"profile": profile_forward(lambda: step(batch_dev)),
                      "card": card}), flush=True)

    # fused vs plain decoder in f32 (TF32 off), same weights
    state_dict = model.state_dict()
    logits32 = {}
    for fused in (True, False):
        m32 = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.float32,
                          device="cuda", fused_eval=fused)
        m32.load_state_dict(state_dict, strict=True)
        logits32[fused] = make_predict_step(m32)(batch_dev[:4])
        del m32
    torch.testing.assert_close(logits32[True], logits32[False], atol=1e-3, rtol=1e-3)
    f32_err = (logits32[True] - logits32[False]).abs().max().item()
    print(json.dumps({"serving": {
        "model": "resnet34 U-Net, 23 classes, fused_eval", "dtype": "bfloat16",
        "batch": 32, "tile": TILE, "forward_ms": forward_ms,
        "tiles_per_s": 32 / forward_ms * 1e3, "peak_mem_gib": peak_gib,
        "f32_fused_vs_plain_max_abs_err": f32_err, "card": card}}), flush=True)
    del model, step, logits, logits32, state_dict, batch_dev
    torch.cuda.empty_cache()

    # 5. the train path: same width, B=32, bf16, the JAX default augmentation
    #    (WEAK: every stage), fused CE, Adam; 5 steps from seeded weights and
    #    seeded numpy batches
    model = create_unet("resnet34", classes=CLASSES, seed=SEED, dtype=torch.bfloat16,
                        device="cuda", fused_eval=True)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    batches = train_batches(host_rng, TRAIN_STEPS)
    train_gen = torch.Generator(device="cuda").manual_seed(SEED)

    # one step on a copy: warms the allocator and cuDNN, takes the census of
    # BatchNorm input shapes, and counts the incoming gradients whose NHWC
    # view is not contiguous (bn_train's backward copies those before the
    # dual sums)
    bn_shapes, dy_copies = collections.Counter(), collections.Counter()
    warm = copy.deepcopy(model)

    def count_dy_copy(mod, grad_out):
        g = grad_out[0]
        if g is not None and not g.movedim(1, -1).is_contiguous():
            dy_copies[(tuple(g.movedim(1, -1).shape), g.element_size())] += 1

    for m in warm.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda mod, inp: bn_shapes.update([tuple(inp[0].permute(0, 2, 3, 1).shape)]))
            m.register_full_backward_pre_hook(count_dy_copy)
    make_supervised_train_step(warm, CLASSES, fused_ce=True)(
        TrainState(warm, adam(1e-4)), torch.Generator(device="cuda").manual_seed(SEED + 1),
        *batches[0])
    torch.cuda.synchronize()
    del warm
    torch.cuda.empty_cache()
    if sum(bn_shapes.values()) != n_bn or dict(bn_shapes) != BN_SHAPES:
        raise AssertionError(f"BatchNorm census {dict(bn_shapes)}, expected {BN_SHAPES}")
    print("BatchNorm inputs of a train step (NHWC shape: count): "
          + ", ".join(f"{s}: {n}" for s, n in sorted(bn_shapes.items())), flush=True)
    copy_bytes = sum(2 * math.prod(shape) * elt * n for (shape, elt), n in dy_copies.items())
    dy_copy_report = {
        "copies_per_step": sum(dy_copies.values()),
        "shapes": {str(shape): n for (shape, _), n in sorted(dy_copies.items())},
        "bytes_per_step": copy_bytes,
        "bound_ms_per_step": roofline(copy_bytes, 0)[0]}
    print(json.dumps({"bn_backward_dy_copies": dy_copy_report, "card": card}), flush=True)

    state = TrainState(model, adam(1e-4))
    train_step = make_supervised_train_step(model, CLASSES, fused_ce=True)   # WEAK
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reset_counts(counters)
    step_metrics = []
    for images, masks in batches:
        state, metrics = train_step(state, train_gen, images, masks)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    train_counts = read_counts(counters)
    expected = {"conv_bn_relu": 0, "channel_sums": n_bn * TRAIN_STEPS,
                "channel_dual_sums": n_bn * TRAIN_STEPS,
                "dihedral_normalize": TRAIN_STEPS, "fused_cross_entropy": 2 * TRAIN_STEPS}
    print(f"main path (training): {TRAIN_STEPS} steps, {n_bn} BatchNorm modules, "
          f"launches {json.dumps(train_counts)}", flush=True)
    if train_counts != expected:
        raise AssertionError(f"launch counts {train_counts}, expected {expected}")
    losses = [m["loss"].item() for m in step_metrics]
    if not all(np.isfinite(losses)) or state.step != TRAIN_STEPS or not model.training:
        raise AssertionError(f"train losses {losses}, step {state.step}")
    for m in step_metrics:
        if m["hist"].sum().item() != TRAIN_BATCH * TILE * TILE:
            raise AssertionError("hist does not count every pixel")
        if not all(torch.isfinite(m[k]).all() for k in ("iou", "accuracy", "per_class_iou")):
            raise AssertionError("metrics not finite")
    after = model.state_dict()
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    # a zero-initialised last BatchNorm scale of a residual block gets a
    # gradient, so every parameter and every buffer must have moved
    if unchanged:
        raise AssertionError(f"left unchanged by training: {unchanged[:5]}")
    del before

    dev_batches = [tuple(torch.from_numpy(a).cuda() for a in b) for b in batches]
    turn = iter(range(10 ** 9))
    timed_step = lambda: train_step(state, train_gen, *dev_batches[next(turn) % TRAIN_STEPS])
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(timed_step, reps=5, warmup=1)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    train_profile = profile_forward(timed_step)
    print(json.dumps({"train_profile": train_profile, "card": card}), flush=True)
    # the step's census: one dihedral_normalize kernel a step (a window the
    # profiler dropped reads "not measured" and is checked per call in 3b)
    census = train_profile.get("by_category_launches", {}).get("dihedral_normalize kernel")
    if "by_category_launches" in train_profile and census != 1:
        raise AssertionError(f"dihedral_normalize kernels per train step: {census}")
    print(json.dumps({"train": {
        "model": "resnet34 U-Net, 23 classes", "dtype": "bfloat16", "batch": TRAIN_BATCH,
        "tile": TILE, "augmentation": "WEAK (the default)", "fused_ce": True,
        "optimizer": "adam(1e-4)", "batch_norm_modules": n_bn, "losses": losses,
        "step_ms": step_ms, "tiles_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_mem_gib": train_peak_gib, "timed_with": "batches already on the device",
        "card": card}}), flush=True)

    # the same step with the dihedral-only augmentation, timed the same way,
    # so that the difference is what the stages after the dihedral one cost
    dihedral_step = make_supervised_train_step(model, CLASSES, aug_cfg=dihedral_only(augment),
                                               fused_ce=True)
    timed_dihedral = lambda: dihedral_step(state, train_gen,
                                           *dev_batches[next(turn) % TRAIN_STEPS])
    torch.cuda.reset_peak_memory_stats()
    dihedral_step_ms = time_ms(timed_dihedral, reps=5, warmup=1)
    dihedral_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    dihedral_profile = profile_forward(timed_dihedral)
    print(json.dumps({"train_dihedral_only": {
        "augmentation": "dihedral only", "step_ms": dihedral_step_ms,
        "tiles_per_s": TRAIN_BATCH / dihedral_step_ms * 1e3, "peak_mem_gib": dihedral_peak_gib,
        "device_ms": dihedral_profile.get("device_ms_per_call"),
        "busy_share": dihedral_profile.get("busy_share"),
        "weak_minus_dihedral_only_ms": step_ms - dihedral_step_ms,
        "weak_minus_dihedral_only_device_ms": (
            train_profile["device_ms_per_call"] - dihedral_profile["device_ms_per_call"]
            if "by_category_ms" in train_profile and "by_category_ms" in dihedral_profile
            else "not measured"),
        "card": card}}), flush=True)

    # 6. the eval step on the trained model: fused decoder, 2 kernel launches
    reset_counts(counters)
    eval_metrics = make_eval_step(model, CLASSES)(*batches[0])
    torch.cuda.synchronize()
    eval_counts = read_counts(counters)
    print(f"main path (eval step): launches {json.dumps(eval_counts)}, "
          f"loss {eval_metrics['loss'].item():.4f}", flush=True)
    if eval_counts["conv_bn_relu"] != 2 or sum(eval_counts.values()) != 2:
        raise AssertionError(f"eval step launch counts {eval_counts}")
    if (not torch.isfinite(eval_metrics["loss"])
            or eval_metrics["hist"].sum().item() != TRAIN_BATCH * TILE * TILE):
        raise AssertionError("eval step metrics are off")
    del model, state, train_step, dihedral_step, dev_batches, step_metrics, eval_metrics
    torch.cuda.empty_cache()

    # 3b. the three training kernels vs their plain versions at the step's shapes
    sums_results = [check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
                    for shape in sorted(BN_SHAPES)]
    for shape in [(32, 512, 512, 16), (32, 256, 256, 32), (32, 16, 16, 512)]:
        check_sums(sums_ops, gen, shape, torch.float32, timed=True)
    for shape in SUMS_EDGE_SHAPES:
        for dtype, dy_dtype in ((torch.bfloat16, None), (torch.float32, None),
                                (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            check_sums(sums_ops, gen, shape, dtype, timed=False, dy_dtype=dy_dtype)
    check_sums(sums_ops, gen, (32, 64, 64, 128), torch.float32, timed=False,
               dy_dtype=torch.bfloat16)
    base = torch.randn(4 * 33 * 16 + 1, generator=gen, device="cuda")
    unaligned = base[1:].view(4, 33, 16)                 # 4 bytes off: the generic path
    torch.testing.assert_close(sums_ops.channel_sums(unaligned),
                               sums_ops.channel_sums_reference(unaligned), rtol=1e-5, atol=1e-4)
    sums_launch_checks = check_sums_launches(sums_ops, gen)
    disc_sums_results = [check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
                         for shape in DISC_BN_SHAPES]
    # phase 11's BatchNorm inputs that the resnet34 step does not have: the
    # resnet50 U-Net's and the feature discriminator's (its 512-channel input
    # is the resnet34 step's (32, 16, 16, 512), timed above); float32 at
    # C >= 1024 takes the generic path
    sums_by_shape = {tuple(r["shape"]): r for r in sums_results}
    for shape in sorted(set(UDA_UNET_BN_SHAPES) | set(UDA_HEAD_BN_SHAPES)):
        if shape not in sums_by_shape:
            sums_by_shape[shape] = check_sums(sums_ops, gen, shape, torch.bfloat16, timed=True)
    resnet50_sums_results = [sums_by_shape[s] for s in sorted(UDA_UNET_BN_SHAPES)
                             if s not in BN_SHAPES]
    head_sums_results = [sums_by_shape[s] for s in UDA_HEAD_BN_SHAPES]
    for shape in [(32, 16, 16, 2048), (32, 32, 32, 1024)]:
        check_sums(sums_ops, gen, shape, torch.float32, timed=False)
    dihedral_result = check_dihedral(dihedral_ops, host_rng)
    dihedral_no_masks = check_dihedral_no_masks(dihedral_ops, host_rng)
    augment_results = time_augment_batch(augment, dihedral_ops, host_rng, card)
    check_augment_card_vs_cpu(augment, dihedral_ops, host_rng)
    ce_results = {dt: check_fused_ce(ce_ops, gen, dt) for dt in (torch.float32, torch.bfloat16)}
    # 3c. each kernel alone in a captured CUDA graph, replayed, against its
    #     eager launch bit for bit
    captured = capture_checks(cbr, sums_ops, dihedral_ops, ce_ops, gen, host_rng)

    # 7. one float32 train step on the card (kernels) against the same step on
    #    a CPU copy of the model (plain versions), WEAK with host draws
    #    (``f32_step_card_vs_cpu``; these seeded draws blur and HSV-shift the
    #    first image).  Every stage on both devices is held in
    #    ``check_augment_card_vs_cpu``.
    f32_step = f32_step_card_vs_cpu(
        "resnet34 U-Net", create_unet("resnet34", classes=CLASSES, seed=SEED,
                                      dtype=torch.float32, device="cpu"),
        f32_draws(augment, host_rng, 2, 256), counters, "segmentation_head.weight",
        fused_ce=True)
    print(json.dumps({"f32_step_gpu_vs_cpu": f32_step}), flush=True)

    # 9. the trainer: SegmentationTrainer.train, 2 epochs over an in-memory
    #    dataset (80 tiles, split 64 / 16, weighted sampler, B=32), in a
    #    process of its own (``trainer_phase``)
    trainer_result = trainer_phase(card)
    trainer_counts = trainer_result["launches"]
    print(json.dumps({"trainer": trainer_result}), flush=True)

    # 10. the three-phase pipeline: run_pipeline, one epoch a phase over
    #     in-memory source and target tiles, in a process of its own
    pipeline_result = pipeline_phase(card)
    pipeline_counts = pipeline_result["launches"]
    print(json.dumps({"pipeline": pipeline_result}), flush=True)

    # 11. the GRL stack: MultiPhaseTrainer at resnet50, one epoch a phase over
    #     the same in-memory tiles, in a process of its own
    t0 = time.perf_counter()
    multiphase_result = multiphase_phase(card)
    multiphase_result["process_wall_s"] = time.perf_counter() - t0      # spawn to result
    multiphase_counts = multiphase_result["launches"]
    print(json.dumps({"multiphase": multiphase_result}), flush=True)

    # 12. the test_system CLI: all 14 suites at the Config defaults, in a
    #     temporary working directory, in a process of its own
    t0 = time.perf_counter()
    system_result = system_phase(card)
    system_result["process_wall_s"] = time.perf_counter() - t0          # spawn to result
    system_counts = system_result["launches"]
    print(json.dumps({"system": system_result}), flush=True)

    # 13. the memory-decomposed phases 2 and 3 and the phase-3 production
    #     point, in a process of its own
    t0 = time.perf_counter()
    production_result = production_phase(card)
    production_result["process_wall_s"] = time.perf_counter() - t0      # spawn to result
    production_counts = production_result["launches"]
    print(json.dumps({"production": production_result}), flush=True)

    # 14. the other families of create_model and the mobilenet_v2 U-Net,
    #     in a process of its own
    t0 = time.perf_counter()
    architectures_result = architectures_phase(card)
    architectures_result["process_wall_s"] = time.perf_counter() - t0   # spawn to result
    architectures_counts = architectures_result["launches"]
    print(json.dumps({"architectures": architectures_result}), flush=True)

    # 15-16. make_scan_driver's CUDA graphs of the train steps, and the
    #        U-Net's fused_decoder schedules, in a process of their own
    t0 = time.perf_counter()
    scan_result = scan_phase(card)
    scan_result["process_wall_s"] = time.perf_counter() - t0            # spawn to result
    scan_counts = scan_result["launches"]
    print(json.dumps({"scan": scan_result["scan"],
                      "process_wall_s": scan_result["process_wall_s"]}), flush=True)
    print(json.dumps({"fused_decoder": scan_result["fused_decoder"]}), flush=True)

    # 17. data parallelism across processes, in a process of its own that
    #     spawns the two ranks of 17b
    t0 = time.perf_counter()
    dist_result = dist_phase(card)
    dist_result["process_wall_s"] = time.perf_counter() - t0           # spawn to result
    dist_counts = dist_result["launches"]
    print(json.dumps({"dist": dist_result}), flush=True)

    # 18. the height-sharded forward across processes, in a process of its own
    #     that spawns the four ranks
    t0 = time.perf_counter()
    spatial_result = spatial_phase(card)
    spatial_result["process_wall_s"] = time.perf_counter() - t0        # spawn to result
    spatial_counts = spatial_result["launches"]
    print(json.dumps({"spatial": spatial_result}), flush=True)

    # 18b. the other segmentation models' height-sharded forward, in a
    #      process of its own that spawns the four ranks
    t0 = time.perf_counter()
    family_result = spatial_phase(card, drive_family_spatial, "phase 18b")
    family_result["process_wall_s"] = time.perf_counter() - t0
    family_counts = family_result["launches"]
    print(json.dumps({"spatial_families": family_result}), flush=True)

    # 8. results
    total = {k: serving_counts[k] + train_counts[k] + eval_counts[k] + trainer_counts[k]
             + pipeline_counts[k] + multiphase_counts[k] + system_counts[k]
             + production_counts[k] + architectures_counts.get(k, 0) + scan_counts[k]
             + dist_counts.get(k, 0) + spatial_counts.get(k, 0)
             + family_counts.get(k, 0) for k in counters}
    if min(total.values()) == 0:
        raise AssertionError(f"a kernel never launched on the main paths: {total}")
    src = f"{PORT}/csrc"
    per_step = lambda key: sum(r[key] * BN_SHAPES[tuple(r["shape"])] for r in sums_results)
    ce32 = ce_results[torch.float32]
    entries = [{
        "name": "conv_bn_relu", "route": "cuda", "source": f"{src}/conv_bn_relu.cu",
        "replaces": f"{JAX_OPS}/pallas_conv.py:173", "launches": total["conv_bn_relu"],
        "max_abs_err": max(r["max_abs_err"] for r in results),
        # per forward: the two decoder launches at B=32, bf16, with the affine
        "ms": sum(r["kernel_ms"] for r in path_cases),
        "plain_ms": sum(r["plain_ms"] for r in path_cases),
        "bound_ms": sum(r["bound_ms"] for r in path_cases),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in path_cases)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in path_cases),
        "capture_check": captured["conv_bn_relu"],
        "share_of_bound": (sum(r["bound_ms"] for r in path_cases)
                           / sum(r["kernel_ms"] for r in path_cases)),
        "per_shape": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "library_ms",
                                         "bound_ms", "share_of_bound",
                                         "kernel_single_launch_ms",
                                         "library_single_launch_ms")}
                      for r in path_cases],
    }, {
        # per train step: one forward and one backward launch per BatchNorm
        "name": "channel_sums", "route": "cuda", "source": f"{src}/channel_sums.cu",
        "replaces": f"{JAX_OPS}/pallas_moments.py:75 and :91",
        "launches": total["channel_sums"] + total["channel_dual_sums"],
        "launches_forward": total["channel_sums"],
        "launches_backward": total["channel_dual_sums"],
        "capture_check": captured["channel_sums"],
        "device_kernels_per_call": sums_launch_checks["device_kernels_per_call"],
        "host_us_per_call": sums_launch_checks["host_us_per_call"],
        "max_abs_err": max(r["max_abs_err"] for r in
                           sums_results + disc_sums_results + list(sums_by_shape.values())
                           + architectures_result["sums_new_shapes"]),
        "max_rel_err": max(r["max_rel_err"] for r in
                           sums_results + disc_sums_results + list(sums_by_shape.values())
                           + architectures_result["sums_new_shapes"]),
        # 20 launches per event pair over rotating cold copies of the inputs
        "ms": per_step("sums_ms") + per_step("dual_ms"),
        "forward_ms": per_step("sums_ms"), "backward_ms": per_step("dual_ms"),
        "single_launch_ms": per_step("sums_single_launch_ms")
        + per_step("dual_single_launch_ms"),
        # the profiler's kernel durations (no host launch overhead)
        "kernel_ms": per_step("sums_kernel_ms") + per_step("dual_kernel_ms"),
        "plain_ms": per_step("sums_plain_ms") + per_step("dual_plain_ms"),
        "forward_plain_ms": per_step("sums_plain_ms"),
        "backward_plain_ms": per_step("dual_plain_ms"),
        "bound_ms": per_step("sums_bound_ms") + per_step("dual_bound_ms"),
        "forward_bound_ms": per_step("sums_bound_ms"),
        "backward_bound_ms": per_step("dual_bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sums_results)
        else "operations",
        "library_ms": per_step("sums_library_ms") + per_step("dual_library_ms"),
        "forward_library_ms": per_step("sums_library_ms"),
        "backward_library_ms": per_step("dual_library_ms"),
        "share_of_bound": ((per_step("sums_bound_ms") + per_step("dual_bound_ms"))
                           / (per_step("sums_ms") + per_step("dual_ms"))),
        "per_shape": [{k: r[k] for k in (
            "shape", "sums_ms", "dual_ms", "sums_bound_ms", "dual_bound_ms",
            "sums_share_of_bound", "dual_share_of_bound", "sums_kernel_ms",
            "dual_kernel_ms", "sums_single_launch_ms",
            "dual_single_launch_ms", "sums_plain_ms", "dual_plain_ms", "sums_library_ms",
            "dual_library_ms")} | {"batch_norms": BN_SHAPES[tuple(r["shape"])]}
            for r in sums_results],
        # the discriminator's three BatchNorm inputs (phases 2 and 3), one each
        "discriminator_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                                    for r in disc_sums_results],
        # phase 11: the resnet50 U-Net's BatchNorm inputs that the resnet34 step
        # lacks, and the feature discriminator's three
        "resnet50_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                               | {"batch_norms": UDA_UNET_BN_SHAPES[tuple(r["shape"])]}
                               for r in resnet50_sums_results],
        "feature_discriminator_per_shape": [{k: r[k] for k in PER_SHAPE_KEYS}
                                            for r in head_sums_results],
        # phase 14: the BatchNorm inputs of the other families and the
        # mobilenet_v2 U-Net that no earlier phase has, and the mobilenet
        # U-Net's 42 inputs of rows that hold no power of two of vectors a step
        "architectures_per_shape": architectures_result["sums_new_shapes"],
        "mobilenet_unet_widened_per_step":
            architectures_result["sums_widened"]["mobilenet_unet_per_step"],
    }, {
        "name": "dihedral_normalize", "route": "cuda",
        "source": f"{src}/dihedral_normalize.cu",
        "replaces": f"{JAX_OPS}/pallas_ops.py:138", "launches": total["dihedral_normalize"],
        "capture_check": captured["dihedral_normalize"],
        "max_abs_err": dihedral_result["max_abs_err"],
        # the mixed batch (all eight elements), 20 launches per event pair, cold
        "ms": dihedral_result["mixed"]["ms"],
        "kernel_ms": dihedral_result["mixed"]["kernel_ms"],
        "single_launch_ms": dihedral_result["mixed"]["single_launch_ms"],
        "plain_ms": dihedral_result["mixed"]["plain_ms"], "bound_ms": dihedral_result["bound_ms"],
        "bound_by": dihedral_result["bound_by"], "library_ms": None,
        "share_of_bound": dihedral_result["mixed"]["share_of_bound"],
        "share_of_bound_kernel_time": dihedral_result["mixed"]["share_of_bound_kernel_time"],
        "device_kernels_per_call": dihedral_result["device_kernels_per_call"],
        "host_us_per_call": dihedral_result["host_us_per_call"],
        "per_class": {cls: dihedral_result[cls] for cls in DIHEDRAL_CLASSES},
        "no_masks": dihedral_no_masks,
    }, {
        # per train step: forward + backward on the f32 logits the model returns
        "name": "fused_cross_entropy", "route": "cuda",
        "source": f"{src}/fused_cross_entropy.cu",
        "replaces": f"{JAX_OPS}/pallas_ops.py:267", "launches": total["fused_cross_entropy"],
        "max_abs_err": max(ce32["max_abs_err"], ce32["grad_max_abs_err"]),
        "ms": ce32["fwd_bwd_ms"], "forward_ms": ce32["fwd_ms"],
        "plain_ms": ce32["plain_fwd_bwd_ms"], "bound_ms": ce32["bound_ms"],
        "bound_by": ce32["bound_by"], "library_ms": ce32["library_fwd_bwd_ms"],
        "capture_check": captured["fused_cross_entropy"],
    }]
    for entry in entries:
        names = (("channel_sums", "channel_dual_sums") if entry["name"] == "channel_sums"
                 else (entry["name"],))
        entry["launches_phase17"] = sum(dist_counts.get(n, 0) for n in names)
        entry["launches_phase18"] = sum(spatial_counts.get(n, 0) for n in names)
        entry["launches_phase18b"] = sum(family_counts.get(n, 0) for n in names)
    print(f"chip_smoke wall time: {time.perf_counter() - t_script:.1f} s (phase 11 with "
          f"its process: {multiphase_result['process_wall_s']:.1f} s, phase 12: "
          f"{system_result['process_wall_s']:.1f} s, phase 13: "
          f"{production_result['process_wall_s']:.1f} s, phase 14: "
          f"{architectures_result['process_wall_s']:.1f} s, phases 15-16: "
          f"{scan_result['process_wall_s']:.1f} s, phase 17: "
          f"{dist_result['process_wall_s']:.1f} s, phase 18: "
          f"{spatial_result['process_wall_s']:.1f} s, phase 18b: "
          f"{family_result['process_wall_s']:.1f} s)", flush=True)
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
