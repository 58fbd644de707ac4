#!/usr/bin/env python3
"""Smoke run of gnn_tpu_torch on one NVIDIA GPU.

1. Device: needs CUDA; prints the card's name and power limit (nvidia-smi)
   and the torch and nvcc versions.
2. Build: compiles the CUDA kernels from gnn_tpu_torch/ops/csrc with nvcc,
   one nvcc per source, all at once; prints each source's nvcc seconds
   against the 900 s limit and the registers and spills ptxas reports.
3. Serving kernels: runs K3 (propagation_loop) and K4 (propagation_step) at
   the shapes the serving path gives them on the full MUTAG-shaped set and
   at ragged small shapes, holds each against its plain PyTorch version on
   the same CUDA tensors (states within 1e-5, movement flags equal) and
   times both with CUDA events, K4 (launch-sized at the 110 dep rows) also by
   the profiler's device time a call. K3's shared-memory plans and occupancy are
   printed, and each of its plans that fits the full set is forced and timed
   (bit-identical to the default plan); K3 also runs at the edges of its
   design (W 32 with D = 1, D = 64, W 96, a dense block, a destination of 40
   arcs, K = 1), each plan forced there too, a repeat launch bit-identical,
   its plan equal to ops/fused.py::_loop_plan's. K4 (redesigned; one staged plan)
   prints its occupancy at the full set and runs at the edges of its design
   (W 32 with D = H = 1, D = H = 64, W 96, a dense block, a destination of 40
   arcs, D != H), with and without rT, a repeat launch bit-identical, its
   shared memory equal to ops/fused.py::_step_bytes'.
4. Serving path: serves the flagship graph-focus GNN (MUTAG widths 14/3/2,
   selu state net with BatchNorm, softmax readout, K=5, threshold 0.01,
   seeded random weights) through Predictor: warmup, then 8 requests. K3 and
   K4 must have launched; every response must match the same model run on
   the CPU (outputs within 1e-5, iteration counts equal).
5. Training kernels: runs K1 (bn_forward_step) and K2 (bn_backward_step) at
   the shapes the training step gives them on the full set and at ragged
   shapes of every register width the kernels are built for, against their
   plain versions (per-node outputs within 1e-5, movement flags equal, sums
   over nodes within rtol 1e-4 with a floor of 1e-4 of the largest entry;
   K2 through the near-kink replica of phase 7, a second launch
   bit-identical), and times both. K1's and K2's shared-memory plans and
   occupancy are printed, and each of their plans that fits the full set is
   forced and timed (bit-identical to the default plan). K1 also runs at the
   edges of its design (W 32 with D = 1, D = 64, a dense block, a destination
   of 40 arcs, no loop rows, a shape only its leanest plan fits): a repeat
   launch bit-identical, its plan equal to ops/bn.py::_bn_plan's, the cases
   reaching both plans.
6. BN-free training kernels: runs K5 (propagation_loop_bwd, with and
   without the affine), K6 (train_step), K7 (train_loop) and K8
   (train_loop_bwd) at the shapes the two BN-free training routes give them
   on the full set and at ragged shapes of every register width, against
   their plain versions in the same way, and times them. K8's plans and
   occupancy are printed and each plan that fits the full set is forced and
   timed (bit-identical); K8 runs at the edges of its design (W 32 with
   D = 1, D = 64 at W 64 and 128, a dense block, a source of 40 arcs, K = 1
   and 5) through the near-kink replica of phase 7 (check_bwd2), its plan
   equal to ops/fused.py::_train_bwd_plan's, the cases reaching both its
   plans. K5 (redesigned) repeats bit for bit on the full set, prints its
   plan and occupancy and runs each plan that fits, forced and timed
   (bit-identical); it runs at the edges of its design (W 32 with D = 1,
   D = 64 at W 64 and 128, a dense block, a node of 40 arcs each way, K = 1
   and 5, each with and without the affine) against its plain version, a
   repeat launch and every plan forced bit-identical, its plan equal to
   ops/fused.py::_loop_bwd_plan's, the cases reaching both its plans. K7
   (redesigned, one staged plan) repeats bit for bit on the full set and prints its
   occupancy; it runs at the edges of its design (W 32 with D = 1, D = 64,
   W 96, a dense block, a destination of 40 arcs, K = 1), each in the three
   dropout modes, against its plain version, a repeat launch bit-identical,
   its shared memory equal to ops/fused.py::_train_loop_bytes'. K6
   (redesigned, one staged plan) repeats bit for bit at the dep rows with and
   without rT and prints its occupancy; it runs at the edges of its design
   (W 32 with D = H = 1, D = H = 64, W 96, a dense block, a destination of 40
   arcs, D 6 with H 9, D 64 with H 5), each in the three dropout modes with
   and without rT, against its plain version, a repeat launch bit-identical,
   its shared memory equal to ops/fused.py::_train_step_bytes'; launch-sized
   at the 110 dep rows, it is also timed by the profiler's device time a
   call.
7. Two-layer kernels: runs K9 (propagation_step2) and K10
   (propagation_loop2) at the shapes the hidden-150 recipe's serving path
   gives them on the full set, K12 (train_loop2) and K13 (train_loop2_bwd)
   at its training shapes, and all four and K11 (propagation_loop2_bwd, with
   the affine) at ragged shapes (W 32/96/128, D 5/14/64, arc-label widths
   3/5/20, H1 16/37/150 and the wrappers' cap 512), against their plain
   versions as in phase 5, and times them. The register-tiled K9, K10, K11,
   K12, K13, K14 and K15 (ops/csrc/tile2.cuh) also run at the edges of their tiling
   (H1 1/7/33/512, W 32 with D = AL = 1, D = AL = 64, a dense adjacency block,
   and the leanest shared-memory plans, one of them at a shape only those
   fit; K14 and K15 with a dep row, K14 at W 96 without loop rows; K9 with
   and without its residual term, once with a destination of 40 arcs), and
   K2 at the same widths (D, F = AL) with a dep row and a row of 40 arcs;
   K9, K10, K12 and K13 must repeat bit for bit on the full set, K9 with
   every plan forced bit-identical at the full set and every edge, K12 and
   K14 at every edge, and the reverse kernels (check_bwd2: K2, K11, K13, K15, K17)
   wherever they run; at every such case the shared-memory plan the library
   takes must equal the Python mirror's (ops/fused2.py::_tile2_plan,
   ops/bn.py::_bn_plan), and the cases must reach every plan of the eight
   lists; at the full set the resident CTAs an SM, registers and local bytes
   a thread are printed, and each plan of K9 and K12 that fits is forced and
   timed (the build's ptxas report goes to chiprun_out/nvcc.log; the registers
   and spills of K3, K4, K7, K9, K10, K12, K1, K2, K8, K14, K16, K17 and K5
   are printed after the build). The
   reverse kernels K2, K11, K13 and K15 differentiate selu: a hidden
   pre-activation within rounding of 0 lets
   the kernel and the plain version take different, equally valid
   derivative branches there, so a block that differs from the plain version
   passes only if the float64 replica of the plain version with the branch
   switched at near-kink units reproduces the kernel within 1e-5 (gnn_tpu's
   adjudication, docs/kernels.md:241-249); every other block is held to the
   plain version (check_bwd2).
8. Two-layer training kernels: runs K11 at the shapes the clean hidden-150
   route gives it on the training batch (1104 loop rows, with and without an
   affine), K14 (bn2_forward_step) and K15 (bn2_backward_step) at the shapes
   the BatchNorm hidden-150 route gives them (all 1214 block rows, H1 = 150),
   and K14/K15 at ragged shapes (W 32/64/96/128, D 5/14/64, F 3/20, H1
   16/37/150 and the cap), against their plain versions as in phase 7, and
   times them. At the full set the tiled K11, K14 and K15 must repeat bit for
   bit, print their occupancy, and run every shared-memory plan that fits,
   forced in turn (bit-identical to the default plan), timed beside it.
9. Serving path 'h150': the hidden-150 accuracy recipe (state net 31 -> 150
   -> 14, selu, AlphaDropout 0.1 at its input, no BatchNorm; readout 14 ->
   150 -> 2, selu and softmax) served through Predictor like the flagship:
   K9 and K10 must launch, no other kernel; outputs within 1e-5 of the CPU
   run, equal iteration counts.
10. Typed kernels: runs K16 (bnT_forward_step) and K17 (bnT_backward_step) at
   the shapes the composite paths give them on the full set with node types
   drawn as benchmarks/composite_bench.py:107-119 does (training: iterations 1
   and 2 and the reverse of 2; serving: the second iteration) and at ragged
   shapes (W 32/64/96/128, D 1/5/14/64, F 0/3/20, T 1/2/3/4/8/32, mixed
   per-type activations, with and without keep-masks and residual rows, an
   absent type, without loop rows, a dense adjacency, the stacked weights in
   shared memory or read through the caches), against their plain versions
   as in phase 5 (K17 through the near-kink replica of phase 7, a repeat
   bit-identical, its plan equal to ops/typed.py::_bnT_bwd_plan's, the cases
   reaching its three plans), and times them; at the full set K16 and K17
   print their occupancy and run each of their plans, forced and timed
   (bit-identical). K16 also runs at the serving full set with every plan
   forced and at the edges of its design (W 32 with D = 1, D = 64, a dense
   block, a destination of 40 arcs, T = 1 and 8, mixed activations, without
   dropout and rT, weights read through the caches, a shape only its leanest
   plan fits): against its plain version, a repeat launch and every plan
   forced bit-identical, its plan equal to ops/typed.py::_bnT_fwd_plan's,
   the cases reaching its three plans.
11. Serving path 'composite': the composite flagship (T = 4 copies of the
   flagship's state net, its readout, non-trivial per-type moving statistics)
   through Predictor on the same requests: K16 must launch K = 5 times a
   request and no other kernel; outputs within 1e-5 of the CPU run, equal
   iteration counts.
12. Training paths, each on one batch of the whole set (softmax readout with
   dropout 0.1 unless said, categorical cross-entropy, Adam lr 1e-3):
   - the flagship (AlphaDropout 0.1 on the state net's input, BatchNorm):
     5 training_steps, K1 and K2 each launched K=5 times per step;
   - the flagship without BatchNorm: 5 steps, K7 and K8 once per step and
     K6 K times;
   - the flagship without BatchNorm and state-net dropout: 3 steps, K3 and
     K5 once per step and K4 K times;
   - the hidden-150 recipe: 4 steps, K12 and K13 once per step (its dep
     blocks take a plain step, as gnn_tpu's do);
   - 'h150_clean', the recipe without dropout in either net: 3 steps, K10
     and K11 once per step and K9 K times;
   - 'h150_bn', the reference's default state net (AlphaDropout 0.1 at its
     input, the trailing BatchNorm) with the recipe's hidden layer and
     readout, non-trivial moving statistics: 3 steps, K14 and K15 K times
     per step;
   - 'composite_bn', the composite flagship on its typed batch: 3 steps, K16
     and K17 K times per step.
   No other kernel may launch on a path. The same model on the CPU, fed the
   card's dropout masks, must agree: equal iteration counts, losses within
   rtol 1e-5, moving BatchNorm statistics within 1e-5, the first step's
   grads within rtol 2e-4 (floor 2e-5 of each tensor's largest entry), the
   params after the last common step within 1e-5. A grad tensor that misses
   its bound is held to the float64 step on the same weights and masks: it
   passes if the card meets the same bound against it, or if the CPU's own
   float32 step misses that bound against float64 too (a set-valued gradient
   at this scale, see phase 7) and the card is norm-wise within 2e-4 of the
   float64 step. A param tensor that misses 1e-5 is held to the float64
   steps from the same weights with the same masks (check_params64): it
   passes if the card is within 1e-5 of them, or if the card's first-step
   grads of the tensor meet the grads bound against float64 and either the
   CPU's float32 steps miss 1e-5 against float64 too or, after one step, the
   card lands within 1e-5 of the optimizer's float64 update on its own grads
   (update64) (Adam's steps move an entry whose gradients are set-valued or
   within rounding of 0 by a share of lr that rounding decides).

13. One node type: a composite model with one type and the flagship's weights
   against the flagship on the same batches: its K16 forward against K3/K4
   (outputs within 1e-5, iterations equal) and one K16/K17 step against K1/K2
   (iterations equal, loss rtol 1e-5, moving statistics 1e-5, grads rtol
   2e-4 with a floor of 2e-5 of each tensor's largest entry).
14. Segment kernel: runs K18 (segment_aggregate) on the CSR plan of the whole
   set as one batch without blocks (GraphDataGenerator(build_plan=True)),
   forward and transpose at D = 14, then at D 1/31/64/150 and on a ragged
   plan (unsorted arcs, a hub of 6000 in-arcs, an isolated node, weight-0
   pads), against its plain version (within 1e-5 of each output's largest
   entry, rows without entries exactly 0, a second launch bit-identical), its
   launch (vector width, lanes a row, rows a CTA, CTAs) held to
   ops/segment.py::_agg_launch; times it, its plain version and
   torch.sparse.mm on the same CSR matrix (the library yardstick) at D 14,
   64 and 150, forward and transpose, and on the ragged plan's hub, and the
   plain body's index_add_ aggregation, by device time (torch.profiler, K18's
   records counted), with CUDA-event times printed beside them.
15. Serving path 'unblocked': Predictor(blocked=False) serves the flagship on
   the same requests, merged into batches without blocks and without a plan,
   as gnn_tpu's: the plain body, no kernel launches; outputs within 1e-5 of
   the CPU run, equal iteration counts.
16. The 'pallas' path: the flagship with aggregation='pallas' on the plan
   batch of the whole set: a forward against the CPU (iterations equal,
   outputs within 1e-5; K18 5 launches), one 32-graph generator batch
   likewise, and 3 BatchNorm training steps as in phase 12, K18 launched 9
   times a step (K forward, K - 1 on the transpose plan: the first iteration
   aggregates the node labels, which need no gradient).

17. Flat layout (after phase 12): blocked batches without the loop/dep layout
   (from_graphs_blocked(..., fused_layout=False): every block a dep block)
   under aggregation='fused', as gnn_tpu's per-step fused path: the flagship
   served through K4 and h150 through K9, K launches a request and no other
   kernel (Predictor(fused_layout=False), outputs within 1e-5 of the CPU run);
   one BatchNorm step (K1/K2 over every block row), one dropout step (K6 per
   step over every block row) and one composite_bn step (K16/K17) on the
   whole set, counted and held to the CPU as phase 12 holds its paths; K4,
   K9 and K6 against their plain versions and timed at these shapes beside
   their dep-row times, K4, K9 and K6 by device time too (K6's plain version
   likewise), K4's and K6's occupancy printed, K9 with each of its plans
   forced and timed (bit-identical).
18. Widths beyond the staged plans (after phase 13). Every kernel with
   shared-memory plans takes every width: where no staged plan fits (K9-K17
   also above D or AL 64, K16/K17 above 32 node types), each takes its wide
   plan (the adjacency lists and the tiles alone in shared memory, the
   [C][W]- and [D][W]-sized regions in the kernel's own outputs or a
   device-memory workspace the wrapper allocates). (1) K1-K8 against their
   plain versions at D 65/80/128/200/201, W 128 and 32, in the three dropout
   modes (K4 and K6 also with D != H, K1, K4 and K6 without rT, K5 without
   the affine; K2 and K8 through check_bwd2), and at W 96 with D 301, W 64
   with D 130 (H 70) and D 1024 at W 128 and 32, their plans held to the
   mirrors', the cases reaching every wide plan. (2) Each wide plan forced at
   D 14 and 64 (W 128 and 32): every output bit for bit the staged plan's.
   (2b) K9-K15 at D and AL (F) 65/80/128/200 and H1 150/513/1024, K16/K17 at
   D 65-200, F 3-80 and T 2/3/4/33/40 (WIDE2_SHAPES, WIDE_T_SHAPES), W 128
   and 32, the kernels with dropout in the three dropout modes, against
   their plain versions (the reverse kernels through check_bwd2), every wide
   plan reached; each of their wide plans forced at D 14 and 64 (H1 150,
   T 4) bit for bit the staged plans'. (3) One-layer models of width 80 and
   128 on fused-layout batches: served through Predictor (K3/K4) and trained
   one step on the 'bn', 'dropout' and 'clean' routes, counted and held to
   the CPU as in phases 4 and 12; params after the step that miss 1e-5
   against the CPU's are held to the float64 step as in phase 12. (4) The two-layer and composite models beyond the staged plans
   (WIDE_PATHS: h150, h150_clean, h150_bn and composite_bn at state width
   80, composite_bn with 33 node types, the h150 routes at arc-label width
   80 and hidden width 600) served (h150, composite_bn) and trained one step
   through K9-K17, counted and held to the CPU likewise; through 'pallas' on
   a plan batch the flagship of width 80 serves and trains on the card (K18:
   K launches a forward, 2K - 1 a step) against the CPU. (5) Width 128 at
   full scale (the MUTAG-shaped set's graphs and arcs, seeded 128-wide node
   labels): K1-K8 at the main paths' shapes timed by events and device time
   beside their bounds, with their plans and workspace bytes; the forward
   and each one-layer route's step by device time; one step each of the
   h150, h150_clean, h150_bn and composite_bn (T 4) routes against the CPU,
   and K9-K17 at those routes' shapes timed likewise.
19. Optimizers: each of the seven optimizers (training/optimizers.py, optax's
   update rules) and Adam on a cosine schedule through 3 steps of the
   flagship's BatchNorm route (K1/K2) on the card, each step held to the
   CPU's from the same params (loss, iterations, moving statistics, grads)
   and the card's update to the CPU optimizer's on the card's grads and
   state (1e-5).
20. Engine (models/engine.py): the flagship (BatchNorm route) trained by
   model.train on the set split by graphs/utils.getindices(4337, 0.7, 0.1,
   seed=0), one fused-layout batch each for training, validation and test:
   8 epochs, update_freq 1, max_fails 3. (a) K1/K2 launched K times by each
   step and K3 once and K4 K times by each evaluation (of a batch with loop
   and dep blocks), no other kernel; (b) epoch 0's step against the CPU with
   the masks the card drew: iterations equal, loss rtol 1e-5, params 1e-5 or
   held to the float64 step as in phase 12 (later epochs only on the card:
   Adam carries selu's set-valued first-layer grads past 1e-5 in a few
   steps); (c) evaluate(gVa) after train reproduces the history's best
   validation loss to 1e-6 relative, the history's columns of equal length;
   (d) test(gTe) against a CPU model given the card's weights through
   get_weights / set_weights: It equal, Loss rtol 1e-5, each metric equal
   unless an output row lies within 1e-5 of an argmax tie; (e)
   save_checkpoint, a fresh model's load_checkpoint, one more epoch from
   both: the dropout masks bit for bit equal, params within 1e-5; (f) LKO
   with 3 folds (graphs/utils.prepare_LKO_data) on 300 graphs, 2 epochs each:
   finite metrics, the test folds disjoint and covering the 300; (g) the
   epochs' EpochSeconds and EdgesPerSecond from the writer's Training.jsonl,
   with the card's name and power limit.
21. LGNN (models/lgnn.py): the 5-layer stack of examples/mutag_lgnn.py:38-62
   (hidden-150 two-layer selu state nets without dropout or BatchNorm, state
   width 14 then 16; selu -> softmax readouts of hidden 150; Adam 1e-3;
   seeded weights; lgnn_model). (a) Predictor(lgnn) on the 8 requests of the
   serving phases: K10 once and, where the request has dep blocks, K9 K times
   a layer a request, no other kernel; outputs within 1e-5 of the same stack
   on the CPU, every layer's iteration count equal; the full-set forward
   timed and profiled. (b) One parallel step on the training batch (K10 5, K11
   5, K9 25 launches, no other), (c) one residual step of the stack's first 3
   layers (K10 3, K11 3, K9 15) and a serial epoch of them (each layer's step,
   evaluation and augmentation: K10 9, K11 3, K9 45; the stack's 5 layers cut
   to 3 to keep the run within 900 s),
   each against the CPU: iterations equal, loss rtol 1e-5, moving statistics
   1e-5, grads and params as in phase 12 (hold_grads, hold_params), the
   float64 twin run on the card through the kernels' plain versions; a grad
   tensor off both the CPU and float64 passes if the card is within its
   bound of the float64 step along the derivative branches the card's
   readouts took (their pre-activations recorded), or norm-wise within 2e-4
   of float64 where, in a tensor whose reverse feeds it, the CPU's float32
   misses float64, or else the float64 step with the state nets' selu units
   within the card's rounding of the kink switched does (hold_stack). (d) lgnn.train for up to 5 epochs
   on the engine's split, then test: finite metrics, K11 5 an epoch, the
   EpochSeconds. (e) The starter's stack (starter.py:58-96 with focus 'g':
   one-layer selu state nets with AlphaDropout 0.1 and BatchNorm, softmax
   readouts with dropout 0.1): one parallel step through K1/K2 (25 launches
   each), the card's masks reused on the CPU, held likewise.
22. Implicit adjoint: one grad_mode='ift' step (20 backward iterations) of the
   clean flagship (K3 once, K4 K times) and of h150_clean (K10 once, K9 K
   times), their state weights scaled by 0.3 for a contractive map (as
   tests/test_torch_ift.py does), as the training paths of phase 12 are held
   to the CPU; K5, K11 and every other backward kernel launch 0 times.

23. state_dim > 0 and the bf16 adjacency: (a) the flagship with
   state_vect_dim = 20 (the labels and their aggregation folded into the
   kernels' features) served through K3/K4 on the 8 requests and one step
   each on the BN (K1/K2), dropout (K7/K8/K6), h150 (K12/K13), h150_clean
   (K10/K11/K9) and composite_bn (K16/K17) routes, held to the CPU as phase
   12 holds its paths (the card's initial states passed to the CPU with its
   masks); (b) the bf16 variants K9_bf16, K10_bf16 and K11_bf16 at the
   shapes the bf16 h150 serving and h150_clean training paths give them,
   against their plain versions on the card by Part B's gate (at least 99%
   of the entries within 1e-5, grads within rtol 2e-4 with a floor of 2e-5
   of the largest entry, and every entry within the change one flip of
   bf(U_a) an iteration makes, a bound run and printed only where an entry
   misses the tolerance; K10_bf16, redesigned with its aggregation
   on bf16 tensor-core tiles, which add in the tensor cores' order: its
   movement flags equal or, where one differs, the plain version's node at
   the threshold within the f32 rounding of the two norms,
   `near_threshold_flags`, and a repeat launch bit for bit), timed beside
   their f32 twins; (c) h150 served on a bf16 full-set batch (K10_bf16 and
   K9_bf16, no other kernel) and 3 h150_clean steps on a bf16 training batch
   (K10_bf16, K11_bf16, K9_bf16 K times): the outputs and the first step's
   iterations, loss and grads held to the CPU (the gate's bound from the CPU
   with one flip an iteration), the later steps on the card alone.
24. The flagship on the bf16 adjacency: (a) the bf16 variants K3_bf16 and
   K4_bf16 at the shapes the bf16 flagship serving path gives them (the
   1440 loop and 110 dep rows) and K1_bf16 and K2_bf16 at those of its BN
   training step (the 1214 block rows, the AlphaDropout masks and residual
   arcs), against their plain versions on the card by Part B's gate (the
   bound from one flip of bf(U_a) for K3/K4, of x3's aggregated slice for
   K1, of bf(dh) for K2), movement flags equal, timed beside their f32
   twins; (b) the flagship served on a bf16 full-set batch: a forward
   launches K3_bf16 once and K4_bf16 K times and no other kernel, the 8
   requests held to the CPU by the gate; (c) 3 BN steps on a bf16 training
   batch (K1_bf16 and K2_bf16 K times a step, no other kernel): the first
   step's iterations, loss, moving statistics and grads held to the CPU
   with the card's masks (the bound from the CPU's step with one flip of
   x3's aggregated slice an iteration), the CPU's BN backward fed the card's
   state cotangent, which is held to the CPU's own within 1e-5 (the
   readout's last bits differ and bf(dh) would round them apart), the later
   steps on the card alone.
25. Training on the bf16 adjacency: (a) the bf16 variants K12_bf16 and
   K13_bf16 at the shapes the hidden-150 recipe's dropout route gives them
   on the bf16 training batch (the 1104 loop rows, the model's AlphaDropout
   masks; K13_bf16 from the plain K12_bf16's trajectory and aggregations
   and a readout-like cotangent) and K5_bf16 at those of the clean route
   (K3_bf16's operands and plain trajectory), against their plain versions
   on the card by Part B's gate (the bound from one flip of x3's aggregated
   slice for K12, of bf(dh0) for K13, of bf(U_a) for K5), movement flags
   equal, timed beside their f32 twins; (b) 3 steps of the recipe with its
   dropout (K12_bf16 and K13_bf16 once a step, the dep blocks' plain f32
   step, no other kernel) and 3 steps of the clean flagship (K3_bf16 and
   K5_bf16 once, K4_bf16 K times a step, no other kernel) on the bf16
   training batch, each first step held to the CPU as phase 24's (c) holds
   its step (the bound from the CPU's step with one flip at the kernel's
   point an iteration).
26. The dropout route on the bf16 adjacency: (a) the bf16 variants K7_bf16
   and K8_bf16 at the shapes the flagship's BatchNorm-free dropout route
   ('dropout': AlphaDropout 0.1 at the state net's input, no BatchNorm)
   gives them on the bf16 training batch (the 1104 loop rows, the model's
   keep-masks; K8_bf16 from the plain K7_bf16's trajectory and aggregations
   and a readout-like cotangent) and K6_bf16 at its first dep step (the 110
   dep rows, the raw residual aggregation) and at the all-dep batch's
   (1194 rows), against their plain versions on the card by Part B's gate
   (the bound from one flip of x2's aggregated slice for K7 and K6, of
   bf(dh) for K8), movement flags equal, timed beside their f32 twins; (b)
   3 steps of 'dropout' on the bf16 training batch (K7_bf16 and K8_bf16
   once and K6_bf16 K times a step, no other kernel: the f32 K6-K8 launch 0
   times) and 1 step of 'flat_dropout' on a bf16 all-dep batch (K6_bf16 K
   times), each first step held to the CPU as phase 24's (c) holds its step
   (the bound from the CPU's step with one flip of x2's aggregated slice an
   iteration).
27. The two-layer BatchNorm route and composite models on the bf16
   adjacency: (a) the bf16 variants K14_bf16 and K15_bf16 at the shapes the
   hidden-150 recipe with its trailing BatchNorm ('h150_bn') gives them on
   the bf16 training batch (the 1214 block rows, the model's AlphaDropout
   masks: iteration 2 and its reverse), K16_bf16 and K17_bf16 at those of
   the composite flagship's 'composite_bn' step (T = 4, 1214 rows) and
   K16_bf16 at the composite serving batch's (1550 rows, rate 0), against
   their plain versions on the card, bit for bit (the per-block partials
   msum, red and dw included; Part B's gate prints the largest difference),
   but K15_bf16, redesigned with its contraction on bf16 tensor-core
   tiles: ds and the per-block partials red held by Part B's gate
   (unsummed, the bound from one flip of bf(dh0)), dagg and the partials
   dw0, dw1 and db1 bit for bit, a repeat launch bit for bit; movement flags
   equal, timed beside their f32 twins;
   (b) 3 'h150_bn' steps on the bf16 training batch (K14_bf16 and K15_bf16 K
   times a step, no other kernel), the composite flagship served on a bf16
   full-set batch (8 requests, K16_bf16 K times a request) and 3
   'composite_bn' steps on a bf16 typed training batch (K16_bf16 and
   K17_bf16 K times a step): the f32 K14-K17 launch 0 times; each first step
   held to the CPU as phase 24's (c) holds its step and the requests as its
   (b) (the bound from one flip of x3's aggregated slice an iteration).

Prints a JSON line of per-kernel numbers (K1-K18 and the bf16 variants
K1_bf16-K17_bf16), then as its last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.

Usage, from the repository root: python3 chip_smoke.py
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

TOL = 1e-5              # kernel vs plain version, card vs CPU
SUM_RTOL = 1e-4         # sums over nodes, kernel vs plain version
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores (NVIDIA's data sheet)
STATE_DIM = 20              # phase 23's separate state width (state_vect_dim)
SEED = 0
T_START = time.perf_counter()
BUILD_S = [0.0]         # the kernels' build, seconds
PORT_KERNELS = set()    # the names of the port's __global__ functions (port_kernel)
CARD = ""               # nvidia-smi's "name, power limit" of the card
# the bf16 variants redesigned on tensor-core tiles, marked in their lines
REDESIGNED = {"K10_bf16": " (redesigned)", "K15_bf16": " (redesigned)"}
BF16_OUT_ERR = {}       # {(kernel, output): largest difference}, check_bf16_kernels'


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def elapsed():
    return f"at {time.perf_counter() - T_START:.1f} s"


def phase_device(torch):
    global CARD
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD = smi.stdout.strip().splitlines()[0]
    say(CARD)
    from gnn_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc.stdout.strip().splitlines()[-1]}; device {torch.cuda.get_device_name(0)}")


def phase_build(force=True):
    """Compiles the kernels (with `force`, whatever the build folder holds)
    and loads the library."""
    from gnn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(force=force)
    _build.library()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "nvcc.log"), "w") as f:
        f.write(_build.build_log)
    BUILD_S[0] = time.perf_counter() - t0
    say(f"build: {BUILD_S[0]:.2f} s -> {_build.LIB_PATH} (nvcc's report: "
        "chiprun_out/nvcc.log)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")
    for label, regs, spills in ptxas_summary(_build.build_log):
        say(f"ptxas {label}: {regs} registers, {spills}")
    say("nvcc seconds by source (each of the 900 s limit, all at once): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(_build.build_seconds.items(),
                                                      key=lambda kv: -kv[1])))


# the kernels whose registers and spills the build's report is read for, by
# their mangled names: K3 (eval_loop.cu, threads), K4 (fused_eval.cu), K6
# and K7 (train_loop.cu), K18 (segment_agg.cu, vector width), K9 (fused2.cu,
# MAXF), K10
# and K12 (loop2.cu, MAXF, TRAIN), K1 (bn_fwd.cu,
# MAXF, threads, keep bytes staged), K2 (bn_train.cu, MAXF, threads, rows
# staged), K8 (train_loop_bwd.cu, one kernel), K14 (bn2_fwd.cu,
# MAXF), K17 (bn_typed.cu, MAXF, threads, rows staged), K16 (bn_typed.cu,
# MAXF, threads, keep bytes staged), K5 (eval_loop_bwd.cu, one kernel)
PTXAS_KERNELS = ((r"11loop_kernelILi(\d+)E", "K3 threads={}"),
                 (r"11step_kernelEPKf", "K4"),
                 (r"17train_step_kernelEPKf", "K6"),
                 (r"17train_loop_kernelEPKf", "K7"),
                 (r"18segment_agg_kernelILi(\d+)E", "K18 V={}"),
                 (r"step2_tile_kernelILi(\d+)E", "K9 MAXF={}"),
                 (r"loop2_tile_kernelILi(\d+)ELb0E", "K10 MAXF={}"),
                 (r"loop2_tile_kernelILi(\d+)ELb1E", "K12 MAXF={}"),
                 (r"bn_fwd_kernelILi(\d+)ELi(\d+)ELb(\d)E", "K1 MAXF={} threads={} staged={}"),
                 (r"16train_bwd_kernelEPKf", "K8"),
                 (r"bn_bwd_kernelILi(\d+)ELi(\d+)ELb(\d)E", "K2 MAXF={} threads={} staged={}"),
                 (r"bn2_fwd_tile_kernelILi(\d+)E", "K14 MAXF={}"),
                 (r"bnT_bwd_kernelILi(\d+)ELi(\d+)ELb(\d)E", "K17 MAXF={} threads={} staged={}"),
                 (r"bnT_fwd_kernelILi(\d+)ELi(\d+)ELb(\d)E", "K16 MAXF={} threads={} staged={}"),
                 (r"15loop_bwd_kernelEPKf", "K5"))


def ptxas_summary(log):
    """(kernel, registers, spill stores/loads) of the PTXAS_KERNELS entries of
    an nvcc -Xptxas -v report."""
    import re
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} bytes spilled (stores/loads)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for pat, label in PTXAS_KERNELS:
                k = re.search(pat, name)
                if k:
                    out.append((label.format(*k.groups()), int(m.group(1)), spills))
            name = None
    return out


def timed_ms(torch, fn, runs=20, reps=5):
    """Median over `runs` of the per-call device time of `reps` back-to-back
    calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(model, gb):
    """K3/K4 operands as the serving path forms them (the first dep step's)."""
    from gnn_tpu_torch.models import core
    loop, dep, Wa = core.hybrid_operands(model.spec, model.params["state"],
                                         model.bn["state"], gb)
    return loop, dict(dep, rT=core.residual_term(gb, dep["s"], Wa))


def random_adj(torch, gen, B, W, dev, dense=False):
    """B sparse 'average'-mode block adjacencies adjT [B, W, W], ~5% arcs
    (every entry nonzero with `dense`)."""
    if dense:
        a = torch.rand(B, W, W, generator=gen) + 0.1
        return (a / a.sum(1, keepdim=True)).to(dev)
    arcs = torch.rand(B, W, W, generator=gen) < 0.05
    return (arcs / arcs.sum(1, keepdim=True).clamp_min(1)).float().to(dev)


def random_inputs(torch, gen, B, W, D, H, dev, res=True):
    """Ragged K4 operands (K3 takes s as s0, with H == D and a node mask)."""
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    aff = torch.stack([torch.rand(H, generator=gen) + 0.5, 0.1 * torch.randn(H, generator=gen)])
    return dict(adjT=random_adj(torch, gen, B, W, dev), s=r(B, W, D),
                rT=r(B, W, H, scale=0.3) if res else None, fT=r(B, W, H, scale=0.3),
                w2=r(2 * H, D, scale=0.7 / D ** 0.5), affine=aff.to(dev))


def _nnz(adjT):
    return int((adjT != 0).sum())


def against_plain(torch, module, name, x):
    """(kernel outputs, plain outputs) of the wrapper `name` of `module` and
    its plain version `name`_ref on the same inputs x."""
    got = getattr(module, name)(**x)
    torch.cuda.synchronize()
    return got, getattr(module, name + "_ref")(**x)


def check_loop(torch, fused, x, K, thr, act, label):
    B, W, _ = x["adjT"].shape
    return check_plain(torch, f"K3 {label}: adjT ({B}, {W}, {W}) D={x['s0'].shape[-1]} K={K} {act}",
                       *against_plain(torch, fused, "propagation_loop",
                                      dict(x, K=K, threshold=thr, activation=act)),
                       ("traj", "margins"), exact=("margins",))


def check_step(torch, fused, x, act, label):
    B, W, _ = x["adjT"].shape
    got, want = against_plain(torch, fused, "propagation_step", dict(x, activation=act))
    return check_plain(torch, f"K4 {label}: adjT ({B}, {W}, {W}) D={x['s'].shape[-1]} "
                       f"H={x['w2'].shape[0] // 2} res={x['rT'] is not None} {act}",
                       (got,), (want,), ("out",))


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def serving_bounds(loop, step, K):
    """(K3, K4) least times and what sets them at the serving path's operands:
    each input read once, each output written once; the dense layer (4*D*D
    a node and iteration), the arcs present and the elementwise work."""
    Bi, W, _ = loop["adjT"].shape
    D = loop["s0"].shape[-1]
    rows3, f4 = Bi * W, 4
    bytes3 = f4 * (Bi * W * W + 2 * rows3 * D + 2 * D * D + 2 * D + rows3
                   + K * rows3 * D + K * rows3)
    flops3 = K * (4 * D * D * rows3 + 2 * D * _nnz(loop["adjT"]) + 5 * D * rows3 + 4 * D * rows3)
    Bd = step["adjT"].shape[0]
    rows4 = Bd * W
    bytes4 = f4 * (Bd * W * W + 4 * rows4 * D + 2 * D * D + 2 * D)
    flops4 = 4 * D * D * rows4 + 2 * D * _nnz(step["adjT"]) + 6 * D * rows4
    return bound(bytes3, flops3), bound(bytes4, flops4)


def phase_kernels(torch, model, gb):
    """Each kernel against its plain version, at the main path's full-set
    shapes and at ragged small shapes; times and bounds at the full set."""
    from gnn_tpu_torch.ops import fused
    K, thr = model.spec.max_iteration, float(model.spec.threshold)
    act = model.spec.state_spec.activations[0]
    loop, step = kernel_inputs(model, gb)
    gen = torch.Generator().manual_seed(SEED)
    dev = gb.device

    err3 = check_loop(torch, fused, loop, K, thr, act, "full set")
    # K3's plan and occupancy, and each of its plans that fits forced and timed
    x3 = dict(loop, K=K, threshold=thr, activation=act)
    dims3 = (loop["adjT"].shape[1], loop["s0"].shape[-1], 0, 0)
    plans3 = time_plans(torch, "K3", fused.propagation_loop, x3, dims3,
                        check_tiled(torch, "K3", fused.propagation_loop, x3, dims3))
    # ragged shapes, one per register width K4 is built for (16, 32, 64)
    for B, W, D, act_r in ((13, 96, 5, "tanh"), (7, 128, 24, "selu"), (4, 64, 48, "relu")):
        small = random_inputs(torch, gen, B, W, D, D, dev, res=False)
        nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
        check_loop(torch, fused, dict(adjT=small["adjT"], s0=small["s"], fT=small["fT"],
                                      w2=small["w2"], affine=small["affine"], nm=nm),
                   3, 0.05, act_r, "ragged")
    # K3 at the edges of its design: W 32 with D 1, D 64, W 96, a dense block,
    # a destination of 40 arcs (its column read from device memory), K 1;
    # against its plain version, a repeat launch and every plan forced
    # bit-identical, the plan the library takes held to the mirror's
    for B, W, D, Kr, act_r, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                     (2, 128, 64, 2, "selu", "D 64"),
                                     (3, 96, 14, 4, "relu", "W 96"),
                                     (3, 128, 14, 3, "selu", "a dense block"),
                                     (3, 128, 14, 3, "tanh", "a destination of 40 arcs"),
                                     (3, 128, 14, 1, "selu", "K 1")):
        small = random_inputs(torch, gen, B, W, D, D, dev, res=False)
        adjT = (random_adj(torch, gen, B, W, dev, dense=True) if edge == "a dense block"
                else small["adjT"])
        if edge == "a destination of 40 arcs":
            adjT[:, :40, 5] = 0.05
        nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
        x = dict(adjT=adjT, s0=small["s"], fT=small["fT"], w2=small["w2"],
                 affine=small["affine"], nm=nm)
        check_loop(torch, fused, x, Kr, 0.05, act_r, f"tiling edge ({edge})")
        check_plans(torch, "K3", fused.propagation_loop,
                    dict(x, K=Kr, threshold=0.05, activation=act_r), (W, D, 0, 0), edge)
    err4 = check_step(torch, fused, step, act, "full set")
    for B, W, D, H, act_r, res in ((5, 64, 6, 9, "relu", True), (3, 32, 3, 3, "linear", False),
                                   (6, 128, 24, 24, "selu", True), (4, 96, 48, 40, "tanh", True),
                                   (3, 128, 20, 64, "selu", True)):
        check_step(torch, fused, random_inputs(torch, gen, B, W, D, H, dev, res=res), act_r,
                   "ragged")
    # K4's occupancy and a repeat launch, with and without rT; then K4 at the
    # edges of its design (W 32 with D = H = 1, D = H = 64, W 96, a dense
    # block, a destination of 40 arcs, D != H), each with and without rT:
    # against its plain version and a repeat launch bit-identical, the shared
    # memory the library takes held to the mirror's
    x4 = dict(step, activation=act)
    dims4 = (step["adjT"].shape[1], step["s"].shape[-1], step["w2"].shape[0] // 2, 0)
    check_tiled(torch, "K4", step_out, x4, dims4)
    check_plans(torch, "K4", step_out, dict(x4, rT=None), dims4, "full set, rT=None")
    for B, W, D, H, act_r, edge in ((4, 32, 1, 1, "tanh", "W 32, D = H = 1"),
                                    (2, 128, 64, 64, "selu", "D = H = 64"),
                                    (3, 96, 14, 14, "relu", "W 96"),
                                    (3, 128, 14, 14, "selu", "a dense block"),
                                    (3, 128, 14, 14, "tanh", "a destination of 40 arcs"),
                                    (3, 64, 6, 9, "relu", "D 6, H 9"),
                                    (2, 128, 64, 5, "selu", "D 64, H 5")):
        small = random_inputs(torch, gen, B, W, D, H, dev, res=True)
        if edge == "a dense block":
            small["adjT"] = random_adj(torch, gen, B, W, dev, dense=True)
        if edge == "a destination of 40 arcs":
            small["adjT"][:, :40, 5] = 0.05
        for x in (small, dict(small, rT=None)):
            label = f"tiling edge ({edge}, res={x['rT'] is not None})"
            check_step(torch, fused, x, act_r, label)
            check_plans(torch, "K4", step_out, dict(x, activation=act_r), (W, D, H, 0), label)

    def run3(f):
        return lambda: f(loop["adjT"], loop["s0"], loop["fT"], loop["w2"], loop["affine"],
                         loop["nm"], K, thr, act)

    def run4(f):
        return lambda: f(step["adjT"], step["s"], step["rT"], step["fT"], step["w2"],
                         step["affine"], act)

    (b3, by3), (b4, by4) = serving_bounds(loop, step, K)
    out = {
        "K3": dict(name="K3 propagation_loop", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/eval_loop.cu",
                   replaces="gnn_tpu/ops/pallas_fused.py:236", max_abs_err=err3,
                   ms=timed_ms(torch, run3(fused.propagation_loop)),
                   plain_ms=timed_ms(torch, run3(fused.propagation_loop_ref)),
                   bound_ms=b3, bound_by=by3, library_ms=None),
        "K4": dict(name="K4 propagation_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/fused_eval.cu",
                   replaces="gnn_tpu/ops/pallas_fused.py:219", max_abs_err=err4,
                   ms=timed_ms(torch, run4(fused.propagation_step)),
                   plain_ms=timed_ms(torch, run4(fused.propagation_step_ref)),
                   bound_ms=b4, bound_by=by4, library_ms=None),
    }
    for k, v in out.items():
        say(f"{k} timing at {('adjT ' + str(tuple((loop if k == 'K3' else step)['adjT'].shape)))}: "
            f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']})" + (f"; each plan forced: {plans3}" if k == "K3" else
                                   f"; device time a call: kernel "
                                   f"{device_ms(torch, run4(fused.propagation_step), 1):.4f} ms, "
                                   f"plain {device_ms(torch, run4(fused.propagation_step_ref)):.4f}"
                                   f" ms"))
    return out


def device_ms(torch, fn, launches=None, runs=50, required=True):
    """Device time per call of fn: the device time of every kernel
    torch.profiler records over `runs` calls, without the host's time between
    launches (which CUDA events over back-to-back calls include when a call's
    host work outlasts its kernels). With `launches`, the port's kernels a
    call launches, only their records count (not the small PyTorch kernels a
    wrapper may launch around them), and they are counted: where the
    profiler returned fewer than runs * launches, that is printed and the
    time is their mean times `launches`. Where no record names a kernel (of
    the port's, with `launches`), it profiles again, and fails after three
    tries (returns None if not `required`): no other record's time stands in
    for the kernel's."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    what = "kernel record" if launches is None else "record of the port's kernels"
    for attempt in range(3):   # the profiler may return no kernel record at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (launches is None or port_kernel(e.key))]
        if rows:
            break
        say(f"device_ms: the profiler returned no {what} (attempt {attempt + 1} of 3)")
    else:
        if not required:
            return None
        fail(f"device_ms: the profiler returned no {what} in 3 attempts")
    total = sum(e.self_device_time_total for e in rows)
    if launches is None:
        return total / runs / 1e3
    seen = sum(e.count for e in rows)
    if seen != runs * launches:
        say(f"device_ms: the profiler returned {seen} kernel records of the {runs * launches} "
            f"launches")
    return total / max(seen, 1) * launches / 1e3


def port_launches():
    """The port's kernel launches so far, summed over every wrapper's count."""
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    return sum(sum(m.launches.values()) for m in (bn, fused, fused2, segment, typed))


def port_kernel(key):
    """Whether a profiler row's kernel is one of the port's: the __global__
    functions of ops/csrc, each in its source's anonymous namespace."""
    import re
    if not PORT_KERNELS:
        from gnn_tpu_torch.ops import _build
        for src in _build.CSRC.glob("*.cu"):
            PORT_KERNELS.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                src.read_text()))
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]", key)
    return m is not None and m.group(1) in PORT_KERNELS


def phase_profile(torch, fwd, runs=5, what="full-set forward"):
    """Device time by kernel over `runs` calls of fwd (torch.profiler), and
    the device's busy share of the host-clock window. The profiler's records
    of the port's kernels are counted against the wrappers' launch counts,
    and a shortfall is printed: the busy share and the rows then read low by
    the dropped records' time."""
    from torch.profiler import ProfilerActivity, profile
    launched = port_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fwd()
        wall_us = (time.perf_counter() - t0) * 1e6
    launched = port_launches() - launched
    # device-side events only: an aten op's own row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[0] for r in rows)
    if not total:
        say("profile: the profiler recorded no device time")
        return
    seen = sum(count for _, count, key in rows if port_kernel(key))
    if seen != launched:
        say(f"profile: the profiler returned {seen} records of the port's kernels for the "
            f"{launched} launches in the window")
    say(f"profile over {runs} x {what}: device busy {total / runs / 1e3:.3f} ms of "
        f"{wall_us / runs / 1e3:.3f} ms per call ({100 * total / wall_us:.1f}% busy)")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        say(f"  {dev_us / runs / 1e3:9.4f} ms/call  {count // runs:4d} launches  {key[:90]}")


# the training paths: the flagship's state net with its BatchNorm ("bn"),
# without it ("dropout"), without BatchNorm and dropout ("clean"), the
# hidden-150 recipe ("h150"), the recipe without dropout ("h150_clean") and
# with the trailing BatchNorm ("h150_bn"), the composite flagship
# ("composite_bn", composite_model) and the flagship with aggregation='pallas'
# on a plan batch ("pallas"), the clean variants trained with the implicit
# adjoint ("ift_clean", "ift_h150_clean": the eval kernels, no backward
# kernel); the kernel wrappers each path launches, and how
# often a step ("K": once per iteration; "2K-1": K forward and K - 1 on the
# transpose plan)
ROUTES = {"bn": {"bn_forward_step": "K", "bn_backward_step": "K"},
          "dropout": {"train_loop": 1, "train_loop_bwd": 1, "train_step": "K"},
          "clean": {"propagation_loop": 1, "propagation_loop_bwd": 1, "propagation_step": "K"},
          "h150": {"train_loop2": 1, "train_loop2_bwd": 1},
          "h150_clean": {"propagation_loop2": 1, "propagation_loop2_bwd": 1,
                         "propagation_step2": "K"},
          "h150_bn": {"bn2_forward_step": "K", "bn2_backward_step": "K"},
          "composite_bn": {"bnT_forward_step": "K", "bnT_backward_step": "K"},
          "pallas": {"segment_aggregate": "2K-1"},
          "flat_bn": {"bn_forward_step": "K", "bn_backward_step": "K"},
          "flat_dropout": {"train_step": "K"},
          "ift_clean": {"propagation_loop": 1, "propagation_step": "K"},
          "ift_h150_clean": {"propagation_loop2": 1, "propagation_step2": "K"},
          "h150_clean_bf16": {"propagation_loop2_bf16": 1, "propagation_loop2_bwd_bf16": 1,
                              "propagation_step2_bf16": "K"},
          "flagship_bf16": {"propagation_loop_bf16": 1, "propagation_step_bf16": "K"},
          "bn_bf16": {"bn_forward_step_bf16": "K", "bn_backward_step_bf16": "K"},
          "h150_bf16": {"train_loop2_bf16": 1, "train_loop2_bwd_bf16": 1},
          "clean_bf16": {"propagation_loop_bf16": 1, "propagation_loop_bwd_bf16": 1,
                         "propagation_step_bf16": "K"},
          "dropout_bf16": {"train_loop_bf16": 1, "train_loop_bwd_bf16": 1,
                           "train_step_bf16": "K"},
          "flat_dropout_bf16": {"train_step_bf16": "K"},
          "h150_bn_bf16": {"bn2_forward_step_bf16": "K", "bn2_backward_step_bf16": "K"},
          "composite_bn_bf16": {"bnT_forward_step_bf16": "K", "bnT_backward_step_bf16": "K"}}


def variant_dims(variant):
    """The widths a flagship variant names ahead of its base: "w<D>_" the
    node-label (and state) width, "a<AL>_" the arc-label width, "t<T>_" the
    node types of a composite variant, "u<H1>_" the hidden width of an h150
    variant, "s<S>_" a separate state of width S (state_vect_dim), "tanh_"
    tanh in place of selu in the nets' hidden layers (defaults 14, 3,
    N_TYPES, 150, 0, selu); {"width", "al", "types", "hidden", "state", "act",
    "base"}."""
    dims = {"width": 14, "al": 3, "types": N_TYPES, "hidden": 150, "state": 0, "act": "selu"}
    keys = {"w": "width", "a": "al", "t": "types", "u": "hidden", "s": "state"}
    head, _, rest = variant.partition("_")
    while rest and (head == "tanh" or head[:1] in keys and head[1:].isdigit()):
        if head == "tanh":
            dims["act"] = head
        else:
            dims[keys[head[0]]] = int(head[1:])
        head, _, rest = rest.partition("_")
    dims["base"] = head + ("_" + rest if rest else "")
    return dims


def variant_width(variant):
    """(node-label width, base variant) of a flagship variant (variant_dims)."""
    dims = variant_dims(variant)
    return dims["width"], dims["base"]


def flagship(torch, device, variant="bn", optimizer="adam", model_kw=None):
    """The flagship (MUTAG widths 14/3/2, K=5, threshold 0.01, seeded random
    weights) with its state net as `variant` says. "h150" is the hidden-150
    accuracy recipe (benchmarks/mutag_single.py with dropout 0.1: hidden
    layers of 150 in both nets, no BatchNorm), "h150_clean" the same with
    dropout 0 (no dropout in either net), "h150_bn" the reference's default
    state net (starter.py: selu, AlphaDropout 0.1 at its input, the trailing
    BatchNorm) with the recipe's hidden layer, and the recipe's readout.
    "pallas" is the flagship with aggregation='pallas' (K18 on a plan batch).
    A variant "ift_<v>" is <v> with grad_mode='ift' (the implicit adjoint,
    20 backward iterations), its state net's weights scaled by 0.3 so that
    the state map is a contraction and the adjoint's Neumann series
    converges (tests/test_torch_ift.py).
    A variant "flat_<v>" is <v> with aggregation='fused', which runs the
    kernels on batches without the loop/dep layout (the all-dep layout); a
    variant "w<D>_<v>" is <v> at node-label (and state) width D, "a<AL>_"
    at arc-label width AL, "u<H1>_" an h150 variant of hidden width H1,
    "s<S>_" <v> with a separate state of width S (state_vect_dim = S),
    "t<T>_composite_bn" the composite flagship with T node types, "tanh_"
    tanh in place of selu (variant_dims). `optimizer`: its optimizer config
    or name; `model_kw`: further keyword arguments of the model class (the
    engine's extra_metrics, path_writer)."""
    from gnn_tpu_torch import GNNgraphBased, MLPSpec, get_inout_dims
    from gnn_tpu_torch.models import core
    dims = variant_dims(variant)
    width, variant = dims["width"], dims["base"]
    if variant == "composite_bn":
        return composite_model(torch, device, T=dims["types"], width=width, optimizer=optimizer,
                               act=dims["act"], state=dims["state"])
    ift = variant.startswith("ift_")
    variant = variant[4:] if ift else variant
    fused = variant.startswith("flat_")
    variant = variant[5:] if fused else variant
    hidden = dims["hidden"] if variant.startswith("h150") else None
    in_s, l_s = get_inout_dims("state", width, dims["al"], 2, "g", dims["state"], hidden)
    in_o, l_o = get_inout_dims("output", width, dims["al"], 2, "g", dims["state"], hidden)
    drop = (dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=True)
            if variant not in ("clean", "h150_clean") else {})
    ss = MLPSpec(input_dim=in_s, units=tuple(l_s), activations=dims["act"],
                 kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                 batch_normalization=variant in ("bn", "h150_bn", "pallas"), **drop)
    out_drop = ({} if variant == "h150_clean" else
                dict(dropout_rate=(0.1,), dropout_pos=(0,), alphadropout=bool(hidden)))
    so = MLPSpec(input_dim=in_o, units=tuple(l_o),
                 activations=(dims["act"], "softmax") if hidden else "softmax",
                 kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
                 batch_normalization=False, **out_drop)
    model = GNNgraphBased(ss, so, optimizer=optimizer, max_iteration=5, threshold=0.01,
                          seed=SEED, device=device, grad_mode="ift" if ift else "unroll",
                          state_vect_dim=dims["state"],
                          **(model_kw or {}),
                          aggregation="pallas" if variant == "pallas" else
                          "fused" if fused else "auto")
    if ift:
        with torch.no_grad():
            for p in core.param_leaves(model.params["state"]):
                p.mul_(0.3)
    if variant in ("bn", "h150_bn", "pallas"):
        gen = torch.Generator().manual_seed(SEED + 1)    # non-trivial inference BN statistics
        d = l_s[-1]
        model.bn["state"] = {"mean": (0.1 * torch.randn(d, generator=gen)).to(device),
                             "var": (0.5 + torch.rand(d, generator=gen)).to(device)}
    return model


def close_sum(torch, got, want, label):
    """Block-summed partials: within SUM_RTOL of the plain version, with a
    floor of SUM_RTOL times the largest entry (a sum can cancel far below
    its terms). Returns the max abs difference."""
    err = (got - want).abs()
    bound = SUM_RTOL * (want.abs() + want.abs().max())
    if not bool((err <= bound).all()):
        fail(f"{label}: sum over nodes off by {float(err.max()):.3e}")
    return float(err.max())


def check_bn_forward(torch, bn, x, kw, label):
    """K1 (x holds w_aug) or K14 (x holds w0_aug, w1, b1) against its plain version."""
    R, W, D = x["y1"].shape
    k, name, net = (("K1", "bn_forward_step", kw.get("activation")) if "w_aug" in x else
                    ("K14", "bn2_forward_step",
                     f"H1={x['w0_aug'].shape[0]} {kw.get('act0')}/{kw.get('act1')}"))
    return check_plain(torch, f"{k} {label}: R={R} (Bl={loop_rows(x)}) W={W} D={D} "
                       f"F={x['feats'].shape[-1]} {net} rate={kw['rate']} "
                       f"res={x['rT'] is not None}",
                       *against_plain(torch, bn, name, dict(x, **kw)),
                       ("y", "agg", "flags", "msum"), summed=("msum",), exact=("flags",))


def loop_rows(x):
    """The loop rows of a BatchNorm kernel's operands (0 without adj_loop)."""
    return 0 if x["adj_loop"] is None else x["adj_loop"].shape[0]


def check_bn_backward(torch, x, kw, label):
    """K2 against its plain version through check_bwd2 (a repeat launch
    bit-identical, near-kink blocks held to the float64 replica)."""
    R, W, D = x["y_prev"].shape
    return check_bwd2(torch, "K2", dict(x, **kw),
                      f"{label}: R={R} (Bl={loop_rows(x)}) W={W} D={D} "
                      f"F={x['feats'].shape[-1]} {kw['activation']} rate={kw['rate']} "
                      f"flag={float(x['flag'])}")


def random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, res, dev, H1=None, dense=False):
    """Ragged K1/K2 operands, or K14/K15 operands with a hidden width H1
    (every adjacency entry nonzero with `dense`)."""
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    adj = random_adj(torch, gen, R, W, dev, dense)
    aff = torch.stack([torch.stack([torch.rand(D, generator=gen) + 0.5,
                                    0.1 * torch.randn(D, generator=gen)]) for _ in range(2)])
    keep = ((torch.rand(R, W, 2 * D + F, generator=gen) > rate).to(torch.uint8).to(dev)
            if rate else None)
    fwd = dict(adj_loop=adj[:Bl].contiguous(), adj_dep=adj[Bl:].contiguous() if Bl < R else None,
               y1=r(R, W, D), y2=r(R, W, D), aff=aff.to(dev), keep=keep,
               rT=r(R, W, D, scale=0.3) if res else None, feats=r(R, W, F, scale=0.5),
               nm=(torch.rand(R, W, generator=gen) < 0.8).float().to(dev))
    C = 2 * D + F + 1
    wts = (dict(w_aug=r(D, C, scale=0.5 / D ** 0.5)) if H1 is None else
           dict(w0_aug=r(H1, C, scale=0.6 / C ** 0.5), w1=r(D, H1, scale=H1 ** -0.5),
                b1=r(D, scale=0.1)))
    fwd.update(wts)
    bwd = dict(adj_loop=fwd["adj_loop"], adj_dep=fwd["adj_dep"], y_prev=fwd["y1"], y_k=r(R, W, D),
               agg=r(R, W, D), keep=keep, feats=fwd["feats"], **wts,
               ds_in=r(R, W, D, scale=0.1), gsel=r(R, W, D, scale=0.1),
               bnv=(0.5 + torch.rand(9, D, generator=gen)).to(dev),
               flag=torch.tensor(1.0, device=dev), nm=fwd["nm"])
    return fwd, bwd


def train_kernel_inputs(torch, model, gb):
    """K1's (K14's for a two-layer state net) operands of iterations 1 and 2
    and K2's (K15's) of the reverse of iteration 2, as the training step
    forms them on the full set (masks from a seeded generator, a
    readout-like state cotangent)."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn
    dev = gb.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    masks = core.draw_masks(model.spec, gb, gen)
    with torch.no_grad():
        s0, weights, op = bn.bn_loop_operands(model.spec, model.params["state"], gb,
                                              masks["state"].get(0))
        wts = dict(zip(("w_aug",) if len(weights) == 1 else ("w0_aug", "w1", "b1"), weights))
        fwd = ((bn.bn_forward_step_bf16_ref, bn.bn2_forward_step_bf16_ref) if op.bf16 else
               (bn.bn_forward_step_ref, bn.bn2_forward_step_ref))[len(weights) != 1]
        gamma, beta = model.params["state"]["bn"]["gamma"], model.params["state"]["bn"]["beta"]
        ident = bn._ident_aff(s0.shape[-1], s0)
        cnt = op.nm.sum().clamp_min(1.0)
        kw = dict(op.step_kw(), threshold=op.threshold)
        x0 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y1=s0, y2=torch.ones_like(s0),
                  aff=torch.stack([ident, ident]), keep=op.keep_k(0),
                  rT=bn._res_term(s0, ident[:, None], op.res, op), feats=op.feats, nm=op.nm,
                  **wts)
        y0, agg0, _, _ = fwd(**x0, **kw)

        def moments(y):
            m = (y * op.nm[..., None]).sum((0, 1)) / cnt
            v = ((y - m) ** 2 * op.nm[..., None]).sum((0, 1)) / cnt
            return m, torch.rsqrt(v + 1e-3), bn._affine(gamma, beta, m, v)

        m0, r0, a0 = moments(y0)
        x1 = dict(x0, y1=y0, y2=s0, aff=torch.stack([a0, ident]), keep=op.keep_k(1),
                  rT=bn._res_term(y0, a0[:, None], op.res, op))
        y1, agg1, _, _ = fwd(**x1, **kw)
        m1, r1, _ = moments(y1)
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        gsel = 0.03 * torch.randn(y1.shape, generator=g, device=dev) * op.nm[..., None]
        s1 = gsel.sum((0, 1))
        s2 = (gsel * (y1 - m1) * r1).sum((0, 1))
        a = gamma * r1
        bnv = torch.stack([a0[0], a0[1], m1, r1, a, a * s1 / cnt, a * s2 / cnt, m0, r0])
        x2 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y_prev=y0, y_k=y1, agg=agg1,
                  keep=op.keep_k(1), feats=op.feats, **wts,
                  ds_in=0.01 * torch.randn(y1.shape, generator=g, device=dev), gsel=gsel,
                  bnv=bnv.contiguous(), flag=torch.tensor(1.0, device=dev), nm=op.nm)
    return (x0, x1), kw, x2, op.step_kw()


def bn_bounds(x_f, x_b):
    """(K1, K2) least times and what sets them: inputs read once, outputs
    written once; operations on the arcs present and the dense layer."""
    adjs = [a for a in (x_f["adj_loop"], x_f["adj_dep"]) if a is not None]
    nnz = sum(_nnz(a) for a in adjs)
    R, W, D = x_f["y1"].shape
    F = x_f["feats"].shape[-1]
    C = 2 * D + F + 1
    n = R * W
    f4 = 4
    keep_b = 0 if x_f["keep"] is None else n * (C - 1)
    adj_b = f4 * sum(a.numel() for a in adjs)
    shared = adj_b + keep_b + f4 * (n * F + D * C + n)          # adjacency, keep, feats, w, nm
    rt_b = 0 if x_f["rT"] is None else f4 * n * D
    bytes1 = shared + f4 * (2 * n * D + 4 * D) + rt_b + f4 * (2 * n * D + n + R * D)
    flops1 = 2 * D * nnz + 2 * D * C * n + 12 * D * n
    bytes2 = shared + f4 * (5 * n * D + 9 * D + 1) + f4 * (2 * n * D + R * D * C + 2 * R * D)
    flops2 = 2 * D * nnz + 2 * D * C * n * 2 + 4 * D * D * n + 14 * D * n
    return bound(bytes1, flops1), bound(bytes2, flops2)


def phase_train_kernels(torch, model, gb):
    """K1/K2 against their plain versions at the training step's full-set
    shapes and at ragged shapes of each register width (16, 32, 64), K2
    through check_bwd2, K1 at the edges of its design; K1's and K2's plans and
    occupancy and each of their plans timed; times and bounds at the full
    set."""
    from gnn_tpu_torch.ops import bn
    (x0, x1), kw, x2, kwb = train_kernel_inputs(torch, model, gb)
    check_bn_forward(torch, bn, x0, kw, "full set, iteration 1")
    err1 = check_bn_forward(torch, bn, x1, kw, "full set, iteration 2")
    err2 = check_bn_backward(torch, x2, kwb, "full set, reverse of iteration 2")
    # K1's and K2's plan and occupancy, and each of their plans that fits
    # forced and timed
    dims = (x2["adj_loop"].shape[1], x2["y_prev"].shape[-1], x2["feats"].shape[-1], 0)
    plans_ms = {}
    for k, kernel, x in (("K1", bn.bn_forward_step, dict(x1, **kw)),
                         ("K2", bn.bn_backward_step, dict(x2, **kwb))):
        first = check_tiled(torch, k, kernel, x, dims)
        plans_ms[k] = time_plans(torch, k, kernel, x, dims, first)
    gen = torch.Generator().manual_seed(SEED + 4)
    dev = gb.device
    # K1 at the edges of its design: W 32 with D 1, D 64, a dense block, a
    # destination of 40 arcs (its column read from device memory), no loop
    # rows (Bl = 0), and a shape only the leanest plan fits; a repeat launch
    # bit-identical, the plan the library takes held to the mirror's, the cases
    # reaching every plan
    reached = {0}
    for R, Bl, W, D, F, act, alpha, rate, edge in (
            (4, 3, 32, 1, 1, "tanh", False, 0.1, "W 32, D 1"),
            (3, 2, 128, 64, 3, "selu", True, 0.1, "D 64"),
            (3, 2, 128, 14, 3, "selu", True, 0.1, "a dense block"),
            (3, 3, 128, 14, 3, "selu", True, 0.1, "a destination of 40 arcs"),
            (3, 0, 96, 14, 3, "relu", False, 0.2, "no loop rows"),
            (2, 1, 128, 64, 80, "tanh", True, 0.1, "a shape only the leanest plan fits")):
        f, _ = random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, True, dev,
                                dense=edge == "a dense block")
        if edge == "a destination of 40 arcs":
            f["adj_loop"][:, :40, 5] = 0.05
        if Bl == 0:     # the all-dep layout: adj_loop None
            f = dict(f, adj_loop=None, adj_dep=torch.cat([f["adj_loop"], f["adj_dep"]]))
        k = dict(activation=act, alpha_drop=alpha, rate=rate, threshold=0.05)
        check_bn_forward(torch, bn, f, k, f"tiling edge ({edge})")
        check_repeat(torch, "K1", bn.bn_forward_step, dict(f, **k), edge)
        reached.add(tiled_plan("K1", W, D, F, 0)["plan"])
    if reached != set(range(len(bn._BN_FWD_PLANS))):
        fail(f"K1: the cases reach plans {sorted(reached)} of its {len(bn._BN_FWD_PLANS)}")
    for R, Bl, W, D, F, act, alpha, rate, res in (
            (6, 4, 32, 5, 3, "selu", True, 0.1, True), (5, 5, 96, 14, 3, "selu", True, 0.1, True),
            (5, 3, 64, 24, 5, "relu", False, 0.2, True), (4, 2, 128, 48, 2, "tanh", True, 0.1, True),
            (3, 3, 64, 64, 1, "linear", False, 0.0, False)):
        f, b = random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, res, dev)
        k = dict(activation=act, alpha_drop=alpha, rate=rate)
        check_bn_forward(torch, bn, f, dict(k, threshold=0.05), "ragged")
        check_bn_backward(torch, b, k, "ragged")
    (b1, by1), (b2, by2) = bn_bounds(x1, x2)
    out = {
        "K1": dict(name="K1 bn_forward_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/bn_fwd.cu",
                   replaces="gnn_tpu/ops/pallas_bn.py:97", max_abs_err=err1,
                   ms=timed_ms(torch, lambda: bn.bn_forward_step(**x1, **kw)),
                   plain_ms=timed_ms(torch, lambda: bn.bn_forward_step_ref(**x1, **kw)),
                   bound_ms=b1, bound_by=by1, library_ms=None),
        "K2": dict(name="K2 bn_backward_step", route="cuda",
                   source="gnn_tpu_torch/ops/csrc/bn_train.cu",
                   replaces="gnn_tpu/ops/pallas_bn.py:203", max_abs_err=err2,
                   ms=timed_ms(torch, lambda: bn.bn_backward_step(**x2, **kwb)),
                   plain_ms=timed_ms(torch, lambda: bn.bn_backward_step_ref(**x2, **kwb)),
                   bound_ms=b2, bound_by=by2, library_ms=None),
    }
    shape = (x1["y1"].shape[0], x1["adj_loop"].shape[0])
    for k, v in out.items():
        say(f"{k} timing at {shape[0]} block rows ({shape[1]} loop): kernel {v['ms']:.4f} ms, "
            f"plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
            f"; each plan forced: {plans_ms[k]}")
    return out


def check_plain(torch, label, got, want, names, summed=(), exact=()):
    """A kernel's outputs against its plain version's on the same inputs:
    per-node outputs within TOL, flags (`exact`) equal, per-block partials
    (`summed`) summed over the blocks within close_sum. Returns the largest
    per-node difference."""
    worst, parts = 0.0, []
    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        if not bool(torch.isfinite(a).all()):
            fail(f"{label}: non-finite {name}")
        if name in exact:
            flips = int((a != b).sum())
            parts.append(f"{name} differing {flips} of {a.numel()}")
            if flips:
                fail(f"{label}: {name} disagrees with its plain version")
        elif name in summed:
            parts.append(f"summed {name} {close_sum(torch, a.sum(0), b.sum(0), f'{label} {name}'):.3e}")
        else:
            err = float((a - b).abs().max())
            worst = max(worst, err)
            parts.append(f"max|{name} - plain| {err:.3e}")
            if err > TOL:
                fail(f"{label}: {name} disagrees with its plain version by {err:.3e} "
                     f"(largest entry {float(b.abs().max()):.3e})")
    say(f"{label}: " + ", ".join(parts))
    return worst


def readout_like(torch, traj, nm, seed):
    """A cotangent of the trajectory as the readout gives it: nonzero only on
    the returned snapshot (here the last) and on real nodes."""
    g = torch.zeros_like(traj)
    gen = torch.Generator(device=traj.device).manual_seed(seed)
    g[-1] = 0.03 * torch.randn(traj.shape[1:], generator=gen, device=traj.device) * nm[..., None]
    return g


def bnfree_kernel_inputs(torch, gb, width=14):
    """K5-K8 operands as the BN-free training paths form them on the full set:
    K7/K8 and K6 (the first dep step) from the flagship without BatchNorm with
    masks from a seeded generator, K5 from the clean flagship (both at state
    width `width`); the forward trajectories from the plain versions and
    readout-like cotangents."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused
    drop_m = flagship(torch, "cuda", f"w{width}_dropout")
    clean = flagship(torch, "cuda", f"w{width}_clean")
    K, thr = drop_m.spec.max_iteration, float(drop_m.spec.threshold)
    masks = core.draw_masks(drop_m.spec, gb, torch.Generator(device=gb.device).manual_seed(SEED + 5))
    with torch.no_grad():
        loop, dep, kw = core.dropout_operands(drop_m.spec, drop_m.params["state"], gb,
                                              masks["state"][0])
        k7 = dict(loop, K=K, threshold=thr, **kw)
        traj, _, agg = fused.train_loop_ref(**k7)
        k8 = dict(adjT=loop["adjT"], s0=loop["s0"], traj=traj, agg=agg, ms=loop["ms"],
                  ma=loop["ma"], fT=loop["fT"], w_cat=loop["w_cat"],
                  g_traj=readout_like(torch, traj, loop["nm"], SEED + 6), **kw)
        drop, _ = fused._make_drop(kw["alpha_drop"], kw["rate"])
        s = dep["s0"]
        k6 = dict(adjT=dep["adjT"], s=s, sd=drop(s, dep["ms"][0]), m=dep["ma"][0],
                  rT=core.residual_agg(gb, s), fT=dep["fT"][0], w_cat=dep["w_cat"], **kw)
        l3, _, _ = core.hybrid_operands(clean.spec, clean.params["state"], clean.bn["state"], gb)
        act = clean.spec.state_spec.activations[0]
        traj3, _ = fused.propagation_loop_ref(**l3, K=K, threshold=thr, activation=act)
        k5 = dict(adjT=l3["adjT"], s0=l3["s0"], traj=traj3, fT=l3["fT"], w2=l3["w2"],
                  affine=None, g_traj=readout_like(torch, traj3, l3["nm"], SEED + 7),
                  activation=act)
    return k5, k6, k7, k8


def dep_step_operands(torch, model, gb, seed):
    """K6's operands (K6_bf16's on a bf16 batch) as the dropout route forms
    them for its first dep step on gb, with the model's keep-masks drawn from
    a generator seeded with `seed`."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused
    masks = core.draw_masks(model.spec, gb, torch.Generator(device=gb.device).manual_seed(seed))
    with torch.no_grad():
        _, dep, kw = core.dropout_operands(model.spec, model.params["state"], gb,
                                           masks["state"][0])
        s = dep["s0"]
        return dict(adjT=dep["adjT"], s=s, sd=fused._make_drop(kw["alpha_drop"], kw["rate"])[0](
            s, dep["ms"][0]), m=dep["ma"][0],
                    rT=core.residual_agg(gb, s, exact=gb.adj_dtype == torch.bfloat16),
                    fT=dep["fT"][0], w_cat=dep["w_cat"], **kw)


def random_bnfree_inputs(torch, gen, B, W, D, H, K, rate, alpha, act, dev, dense=False,
                         line=False, column=False):
    """Ragged K5-K8 operands: a sparse 'average' adjacency (every entry
    nonzero with `dense`; with `line` source 3 of every block has 40 arcs,
    with `column` destination 3 has 40),
    keep bits and weights that keep the states O(1); K8's and K5's
    trajectories from the plain forwards. K6 is H wide, the loops D wide."""
    from gnn_tpu_torch.ops import fused

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def keep(*shape):
        return (torch.rand(*shape, generator=gen) > rate).to(torch.uint8).to(dev) if rate else None
    adjT = random_adj(torch, gen, B, W, dev, dense)
    if line:
        adjT[:, 3, :40] = 0.05   # a row of 40 arcs: read from device memory
    if column:
        adjT[:, :40, 3] = 0.05   # a column of 40 arcs
    nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    k7 = dict(adjT=adjT, s0=r(B, W, D), ms=keep(K, B, W, D), ma=keep(K, B, W, D),
              fT=r(K, B, W, D, scale=0.3), w_cat=r(D, 2 * D, scale=0.5 / D ** 0.5), nm=nm, K=K,
              threshold=0.05, **kw)
    traj, _, agg = fused.train_loop_ref(**k7)
    k8 = dict(adjT=adjT, s0=k7["s0"], traj=traj, agg=agg, ms=k7["ms"], ma=k7["ma"],
              fT=k7["fT"], w_cat=k7["w_cat"], g_traj=r(K, B, W, D, scale=0.1), **kw)
    k6 = dict(adjT=adjT, s=r(B, W, D), sd=r(B, W, D), m=keep(B, W, D), rT=r(B, W, D, scale=0.3),
              fT=r(B, W, H, scale=0.3), w_cat=r(H, 2 * D, scale=0.5 / D ** 0.5), **kw)
    w2 = r(2 * D, D, scale=0.5 / D ** 0.5)
    aff = torch.stack([torch.rand(D, generator=gen) + 0.5, 0.1 * torch.randn(D, generator=gen)])
    traj3, _ = fused.propagation_loop_ref(adjT, k7["s0"], k7["fT"][0], w2, aff.to(dev), nm, K,
                                          0.05, act)
    k5 = dict(adjT=adjT, s0=k7["s0"], traj=traj3, fT=k7["fT"][0], w2=w2, affine=aff.to(dev),
              g_traj=r(K, B, W, D, scale=0.1), activation=act)
    return k5, k6, k7, k8


def check_bnfree(torch, k5, k6, k7, k8, label):
    """K5-K8 against their plain versions. Returns their largest per-node
    differences."""
    from gnn_tpu_torch.ops import fused

    def run(name, x):
        return against_plain(torch, fused, name, x)
    B, W, D = k7["s0"].shape
    shape = f"B={B} W={W} D={D} K={k7['K']} {k7['activation']} rate={k7['rate']}"
    return {
        "K5": check_plain(torch, f"K5 {label} ({shape}, affine={k5['affine'] is not None})",
                          *run("propagation_loop_bwd", k5), ("gs", "dw2", "dfT", "daff"),
                          summed=("dw2", "daff")),
        "K6": check_plain(torch, f"K6 {label} (Bd={k6['adjT'].shape[0]}, H={k6['fT'].shape[-1]}, "
                          f"res={k6['rT'] is not None})", *run("train_step", k6), ("y", "agg")),
        "K7": check_plain(torch, f"K7 {label} ({shape})", *run("train_loop", k7),
                          ("traj", "margins", "agg"), exact=("margins",)),
        "K8": check_plain(torch, f"K8 {label} ({shape})", *run("train_loop_bwd", k8),
                          ("gs", "dw", "dfT"), summed=("dw",)),
    }


def bnfree_bounds(k5, k6, k7, k8):
    """(K5, K6, K7, K8) least times and what sets them: each input read once
    (the trajectories' last iteration is not an input of a reverse step),
    each output written once; operations on the arcs present plus the dense
    layer (4*D*D a node and iteration), its reverse and the elementwise work."""
    f4 = 4
    B, W, D = k7["s0"].shape
    K = k7["K"]
    n = B * W
    adj, nnz = f4 * k7["adjT"].numel(), _nnz(k7["adjT"])
    masks = 0 if k7["ms"] is None else 2 * K * n * D
    w = f4 * 2 * D * D
    bytes7 = adj + f4 * n * D + masks + f4 * K * n * D + w + f4 * n + f4 * K * n * (2 * D + 1)
    flops7 = K * (2 * D * nnz + 4 * D * D * n + 12 * D * n)
    bytes8 = (adj + f4 * n * D + f4 * (K - 1) * n * D + masks + f4 * 3 * K * n * D + w
              + f4 * n * D + f4 * B * 2 * D * D + f4 * K * n * D)
    flops8 = K * (2 * D * nnz + 12 * D * D * n + 16 * D * n)
    Bd, H = k6["fT"].shape[0], k6["fT"].shape[-1]
    nd = Bd * W
    bytes6 = (f4 * k6["adjT"].numel() + f4 * 3 * nd * D + (0 if k6["m"] is None else nd * D)
              + f4 * nd * H + f4 * 2 * H * D + f4 * nd * (H + D))
    flops6 = 2 * D * _nnz(k6["adjT"]) + 4 * D * H * nd + 8 * D * nd
    B5 = k5["adjT"].shape[0]
    n5 = B5 * W
    aff = 0 if k5["affine"] is None else f4 * (2 * D + B5 * 2 * D)
    bytes5 = (f4 * k5["adjT"].numel() + f4 * n5 * D * (K + 1) + w + f4 * K * n5 * D
              + f4 * 2 * n5 * D + f4 * B5 * 2 * D * D + aff)
    flops5 = K * (4 * D * _nnz(k5["adjT"]) + 12 * D * D * n5 + 10 * D * n5)
    return (bound(bytes5, flops5), bound(bytes6, flops6), bound(bytes7, flops7),
            bound(bytes8, flops8))


def phase_bnfree_kernels(torch, gb):
    """K5-K8 against their plain versions at the BN-free training paths'
    full-set shapes (K5 with and without the affine) and at ragged shapes of
    each register width (16, 32, 64), K5 and K8 at the edges of their
    designs; K5's and K8's plans and occupancy and each of their plans
    timed; times and bounds at the full set."""
    from gnn_tpu_torch.ops import fused
    k5, k6, k7, k8 = bnfree_kernel_inputs(torch, gb)
    errs = check_bnfree(torch, k5, k6, k7, k8, "full set")
    gen = torch.Generator().manual_seed(SEED + 8)
    aff = torch.stack([torch.rand(k5["s0"].shape[-1], generator=gen) + 0.5,
                       0.1 * torch.randn(k5["s0"].shape[-1], generator=gen)]).to(gb.device)
    check_plain(torch, "K5 full set, affine", fused.propagation_loop_bwd(**dict(k5, affine=aff)),
                fused.propagation_loop_bwd_ref(**dict(k5, affine=aff)), ("gs", "dw2", "dfT", "daff"),
                summed=("dw2", "daff"))
    # K5's plan and occupancy, each of its plans that fits forced and timed,
    # and every plan forced with the affine; then K5 at the edges of its
    # design, with and without the affine: against its plain version, a
    # repeat launch and every plan forced bit-identical, the plan the library
    # takes held to the mirror's, the cases reaching both plans
    dims5 = (k5["adjT"].shape[1], k5["s0"].shape[-1], 0, 0)
    gen5 = torch.Generator().manual_seed(SEED + 9)
    reached5 = {0}
    plans5 = time_plans(torch, "K5", fused.propagation_loop_bwd, k5, dims5,
                        check_tiled(torch, "K5", fused.propagation_loop_bwd, k5, dims5))
    check_plans(torch, "K5", fused.propagation_loop_bwd, dict(k5, affine=aff), dims5,
                "full set, affine")
    for B, W, D, K, act, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                  (2, 64, 64, 2, "selu", "D 64 at W 64"),
                                  (2, 128, 64, 2, "selu", "D 64"),
                                  (3, 128, 14, 3, "selu", "a dense block"),
                                  (3, 128, 14, 3, "relu", "a node of 40 arcs each way"),
                                  (3, 128, 14, 1, "selu", "K 1"),
                                  (3, 128, 14, 5, "tanh", "K 5")):
        x5 = random_bnfree_inputs(torch, gen5, B, W, D, D, K, 0.0, True, act, gb.device,
                                  dense=edge == "a dense block",
                                  line=edge == "a node of 40 arcs each way",
                                  column=edge == "a node of 40 arcs each way")[0]
        for xa in (x5, dict(x5, affine=None)):
            label = (f"tiling edge ({edge}: B={B} W={W} D={D} K={K} {act}, "
                     f"affine={xa['affine'] is not None})")
            check_plain(torch, f"K5 {label}", *against_plain(torch, fused, "propagation_loop_bwd", xa),
                        ("gs", "dw2", "dfT", "daff"), summed=("dw2", "daff"))
            check_plans(torch, "K5", fused.propagation_loop_bwd, xa, (W, D, 0, 0), label)
        reached5.add(tiled_plan("K5", W, D, 0, 0)["plan"])
    if reached5 != set(range(len(fused._LOOP_BWD_PLANS))):
        fail(f"K5: the cases reach plans {sorted(reached5)} of its {len(fused._LOOP_BWD_PLANS)}")
    for B, W, D, H, K, rate, alpha, act in (
            (5, 32, 5, 7, 3, 0.2, True, "selu"), (3, 96, 14, 14, 4, 0.15, False, "tanh"),
            (4, 64, 24, 20, 3, 0.1, True, "relu"), (2, 128, 48, 40, 2, 0.0, True, "linear"),
            (3, 64, 64, 64, 2, 0.1, False, "selu")):
        check_bnfree(torch, *random_bnfree_inputs(torch, gen, B, W, D, H, K, rate, alpha, act,
                                                  gb.device), "ragged")
    # K7's occupancy and a repeat launch; then K7 at the edges of its design
    # (W 32 with D 1, D 64, W 96, a dense block, a destination of 40 arcs,
    # K 1) in each dropout mode (alpha, standard, none): against its plain
    # version and a repeat launch bit-identical (traj, margins, agg), the
    # shared memory the library takes held to the mirror's
    check_tiled(torch, "K7", fused.train_loop, k7, (k7["adjT"].shape[1], k7["s0"].shape[-1], 0, 0))
    gen7 = torch.Generator().manual_seed(SEED + 10)
    for B, W, D, K, act, edge in ((4, 32, 1, 3, "tanh", "W 32, D 1"),
                                  (2, 128, 64, 2, "selu", "D 64"),
                                  (3, 96, 14, 4, "relu", "W 96"),
                                  (3, 128, 14, 3, "selu", "a dense block"),
                                  (3, 128, 14, 3, "tanh", "a destination of 40 arcs"),
                                  (3, 128, 14, 1, "selu", "K 1")):
        for rate, alpha in ((0.1, True), (0.1, False), (0.0, True)):
            x7 = random_bnfree_inputs(torch, gen7, B, W, D, D, K, rate, alpha, act, gb.device,
                                      dense=edge == "a dense block",
                                      column=edge == "a destination of 40 arcs")[2]
            label = f"tiling edge ({edge}: B={B} W={W} D={D} K={K} {act} rate={rate} alpha={alpha})"
            check_plain(torch, f"K7 {label}", *against_plain(torch, fused, "train_loop", x7),
                        ("traj", "margins", "agg"), exact=("margins",))
            check_plans(torch, "K7", fused.train_loop, x7, (W, D, 0, 0), label)
    # K6's occupancy and a repeat launch at the dep rows, with and without
    # rT; then K6 at the edges of its design (W 32 with D = H = 1, D = H = 64,
    # W 96, a dense block, a destination of 40 arcs, D != H both ways) in
    # each dropout mode, with and without rT: against its plain version and a
    # repeat launch bit-identical (y, agg), the shared memory the library
    # takes held to the mirror's
    dims6 = (k6["adjT"].shape[1], k6["s"].shape[-1], k6["fT"].shape[-1], 0)
    check_tiled(torch, "K6", fused.train_step, k6, dims6)
    check_plans(torch, "K6", fused.train_step, dict(k6, rT=None), dims6, "dep rows, res=False")
    gen6 = torch.Generator().manual_seed(SEED + 12)
    for B, W, D, H, act, edge in ((4, 32, 1, 1, "tanh", "W 32, D = H = 1"),
                                  (2, 128, 64, 64, "selu", "D = H = 64"),
                                  (3, 96, 14, 14, "relu", "W 96"),
                                  (3, 128, 14, 14, "selu", "a dense block"),
                                  (3, 128, 14, 14, "tanh", "a destination of 40 arcs"),
                                  (3, 64, 6, 9, "relu", "D 6, H 9"),
                                  (2, 128, 64, 5, "selu", "D 64, H 5")):
        for rate, alpha in ((0.1, True), (0.1, False), (0.0, True)):
            x6 = random_bnfree_inputs(torch, gen6, B, W, D, H, 2, rate, alpha, act, gb.device,
                                      dense=edge == "a dense block",
                                      column=edge == "a destination of 40 arcs")[1]
            for xr in (x6, dict(x6, rT=None)):
                label = (f"design edge ({edge}: B={B} W={W} {act} rate={rate} alpha={alpha} "
                         f"res={xr['rT'] is not None})")
                check_plain(torch, f"K6 {label}", *against_plain(torch, fused, "train_step", xr),
                            ("y", "agg"))
                check_plans(torch, "K6", fused.train_step, xr, (W, D, H, 0), label)
    # K8's plan and occupancy and each of its plans that fits forced and
    # timed; then K8 at the edges of its design (W 32 with D 1, D 64, a
    # dense block, a source of 40 arcs, K 1 and 5) through check_bwd2, the
    # plan the library takes held to the mirror's, the cases reaching every
    # plan
    dims = (k8["adjT"].shape[1], k8["s0"].shape[-1], 0, 0)
    plans_ms = time_plans(torch, "K8", fused.train_loop_bwd, k8, dims,
                          check_tiled(torch, "K8", fused.train_loop_bwd, k8, dims))
    reached = {0}
    for B, W, D, K, rate, alpha, act, edge in (
            (4, 32, 1, 3, 0.1, False, "tanh", "W 32, D 1"),
            (2, 64, 64, 2, 0.1, True, "selu", "D 64 at W 64"),
            (2, 128, 64, 2, 0.1, False, "selu", "D 64"),
            (3, 128, 14, 3, 0.1, True, "selu", "a dense block"),
            (3, 128, 14, 3, 0.15, False, "relu", "a source of 40 arcs"),
            (3, 128, 14, 1, 0.1, True, "selu", "K 1"),
            (3, 128, 14, 5, 0.1, True, "selu", "K 5")):
        x = random_bnfree_inputs(torch, gen, B, W, D, D, K, rate, alpha, act, gb.device,
                                 dense=edge == "a dense block",
                                 line=edge == "a source of 40 arcs")[3]
        check_bwd2(torch, "K8", x, f"tiling edge ({edge}: B={B} W={W} D={D} K={K} {act} "
                                   f"rate={rate})")
        reached.add(tiled_plan("K8", W, D, 0, 0)["plan"])
    if reached != set(range(len(fused._TRAIN_BWD_PLANS))):
        fail(f"K8: the cases reach plans {sorted(reached)} of its {len(fused._TRAIN_BWD_PLANS)}")
    bounds = bnfree_bounds(k5, k6, k7, k8)
    out = {}
    for (k, name, src, line), x, (b, by) in zip(
            (("K5", "propagation_loop_bwd", "eval_loop_bwd.cu", 517),
             ("K6", "train_step", "train_loop.cu", 662),
             ("K7", "train_loop", "train_loop.cu", 849),
             ("K8", "train_loop_bwd", "train_loop_bwd.cu", 992)), (k5, k6, k7, k8), bounds):
        kernel, plain = getattr(fused, name), getattr(fused, name + "_ref")
        out[k] = dict(name=f"{k} {name}", route="cuda", source=f"gnn_tpu_torch/ops/csrc/{src}",
                      replaces=f"gnn_tpu/ops/pallas_fused.py:{line}", max_abs_err=errs[k],
                      ms=timed_ms(torch, lambda: kernel(**x)),
                      plain_ms=timed_ms(torch, lambda: plain(**x)),
                      bound_ms=b, bound_by=by, library_ms=None)
        say(f"{k} timing at adjT {tuple(x['adjT'].shape)}: kernel {out[k]['ms']:.4f} ms, plain "
            f"{out[k]['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})"
            + (f"; device time a call {device_ms(torch, lambda: kernel(**x), 1):.4f} ms"
               if k in ("K5", "K7") else "")
            + (f"; device time a call: kernel {device_ms(torch, lambda: kernel(**x), 1):.4f} ms, "
               f"plain {device_ms(torch, lambda: plain(**x)):.4f} ms" if k == "K6" else "")
            + (f"; each plan forced: {plans_ms}" if k == "K8" else "")
            + (f"; each plan forced: {plans5}" if k == "K5" else ""))
    return out


def two_layer_kernel_inputs(torch, gb, gb_train, width=14):
    """K9/K10 operands as the hidden-150 recipe's serving path forms them on
    the full set (K9 the first dep step's), K12/K13 operands as its training
    step forms them (masks from a seeded generator; K13's trajectory from the
    plain forward and a readout-like cotangent); the recipe at node-label
    width `width`."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused2
    model = flagship(torch, "cuda", f"w{width}_h150")
    spec, p = model.spec, model.params["state"]
    K, thr = spec.max_iteration, float(spec.threshold)
    acts = dict(zip(("act0", "act1"), spec.state_spec.activations))
    with torch.no_grad():
        loop, dep = core.hybrid2_operands(spec, p, model.bn["state"], gb)
        k10 = dict(loop, K=K, threshold=thr, **acts)
        k9 = dict(dep, rT=core.residual_agg(gb, dep["s"]), **acts)
        masks = core.draw_masks(spec, gb_train,
                                torch.Generator(device=gb.device).manual_seed(SEED + 9))
        loop2, _, kw = core.dropout2_operands(spec, p, gb_train, masks["state"][0])
        k12 = dict(loop2, K=K, threshold=thr, **kw)
        traj, _, agg = fused2.train_loop2_ref(**k12)
        k13 = dict(adjT=loop2["adjT"], s0=loop2["s0"], traj=traj, agg=agg, ms=loop2["ms"],
                   ma=loop2["ma"], fd=loop2["fd"], w0=loop2["w0"], b0=loop2["b0"], w1=loop2["w1"],
                   b1=loop2["b1"], g_traj=readout_like(torch, traj, loop2["nm"], SEED + 10), **kw)
    return k9, k10, k12, k13


def random_two_layer_inputs(torch, gen, B, W, D, AL, H1, K, acts, rate, alpha, dev,
                            dense=False):
    """Ragged K9/K10/K12/K13 and K11 operands: a sparse 'average' adjacency
    (every entry nonzero with `dense`), keep bits and weights that keep the
    states O(1); K13's trajectory from the plain K12, K11's (with the affine)
    from the plain K10."""
    from gnn_tpu_torch.ops import fused2

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    def keep(*shape):
        return (torch.rand(*shape, generator=gen) > rate).to(torch.uint8).to(dev) if rate else None
    C = 2 * D + AL
    wts = dict(w0=r(H1, C, scale=0.8 / C ** 0.5), b0=r(H1, scale=0.2),
               w1=r(D, H1, scale=1.0 / H1 ** 0.5), b1=r(D, scale=0.1))
    adjT = random_adj(torch, gen, B, W, dev, dense)
    nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
    aff = torch.stack([torch.rand(D, generator=gen) + 0.5, 0.1 * torch.randn(D, generator=gen)])
    a2 = dict(zip(("act0", "act1"), acts))
    kw = dict(a2, alpha_drop=alpha, rate=rate)
    k9 = dict(adjT=adjT, s=r(B, W, D), rT=r(B, W, D, scale=0.3), feats=r(B, W, AL, scale=0.5),
              affine=aff.to(dev), **wts, **a2)
    k10 = dict(adjT=adjT, s0=k9["s"], feats=k9["feats"], affine=aff.to(dev), nm=nm, K=K,
               threshold=0.05, **wts, **a2)
    k12 = dict(adjT=adjT, s0=k9["s"], ms=keep(K, B, W, D), ma=keep(K, B, W, D),
               fd=r(K, B, W, AL, scale=0.5), nm=nm, K=K, threshold=0.05, **wts, **kw)
    traj, _, agg = fused2.train_loop2_ref(**k12)
    k13 = dict(adjT=adjT, s0=k12["s0"], traj=traj, agg=agg, ms=k12["ms"], ma=k12["ma"],
               fd=k12["fd"], g_traj=r(K, B, W, D, scale=0.1), **wts, **kw)
    traj10, _ = fused2.propagation_loop2_ref(**k10)
    k11 = dict(adjT=adjT, s0=k10["s0"], traj=traj10, feats=k10["feats"], affine=k10["affine"],
               g_traj=r(K, B, W, D, scale=0.1), **wts, **a2)
    return k9, k10, k12, k13, k11


KINKED = ("selu", "relu")   # activations whose derivative jumps at 0

# The reverse kernels held by check_bwd2: module, wrapper, its outputs (name,
# block axis, "node" for per-node values or "part" for per-block partials) and
# the block axis of each input a block's replica slices.
BWD2 = {
    "K11": ("fused2", "propagation_loop2_bwd",
            (("gs", 0, "node"), ("dw0", 0, "part"), ("db0", 0, "part"), ("dw1", 0, "part"),
             ("db1", 0, "part"), ("dfeats", 0, "node"), ("daff", 0, "part")),
            {"adjT": 0, "s0": 0, "traj": 1, "feats": 0, "g_traj": 1}),
    "K13": ("fused2", "train_loop2_bwd",
            (("gs", 0, "node"), ("dw0", 0, "part"), ("db0", 0, "part"), ("dw1", 0, "part"),
             ("db1", 0, "part"), ("dfd", 1, "node")),
            {"adjT": 0, "s0": 0, "traj": 1, "agg": 1, "ms": 1, "ma": 1, "fd": 1, "g_traj": 1}),
    "K15": ("bn", "bn2_backward_step",
            (("ds", 0, "node"), ("dw0", 0, "part"), ("dw1", 0, "part"), ("db1", 0, "part"),
             ("dagg", 0, "node"), ("red", 0, "part")),
            {"y_prev": 0, "y_k": 0, "agg": 0, "keep": 0, "feats": 0, "ds_in": 0, "gsel": 0,
             "nm": 0}),
    "K8": ("fused", "train_loop_bwd", (("gs", 0, "node"), ("dw", 0, "part"), ("dfT", 1, "node")),
           {"adjT": 0, "s0": 0, "traj": 1, "agg": 1, "ms": 1, "ma": 1, "fT": 1, "g_traj": 1}),
    "K2": ("bn", "bn_backward_step",
           (("ds", 0, "node"), ("dw", 0, "part"), ("dagg", 0, "node"), ("red", 0, "part")),
           {"y_prev": 0, "y_k": 0, "agg": 0, "keep": 0, "feats": 0, "ds_in": 0, "gsel": 0,
            "nm": 0}),
    "K17": ("typed", "bnT_backward_step",
            (("ds", 0, "node"), ("dw", 0, "part"), ("dagg", 0, "node"), ("red", 0, "part")),
            {"y_prev": 0, "y_k": 0, "agg": 0, "types": 0, "keep": 0, "feats": 0, "ds_in": 0,
             "gsel": 0, "nm": 0}),
}


def act_grad_hook(torch, flips=(), record=None):
    """A derivative for the plain reverse versions' act_grad: the kernel
    activations' own, except at flips {(site, flat index)}, where it takes
    the other branch of a kinked activation; site n is the n-th call (the
    versions take act1's, then act0's, in reverse iteration order). With
    `record`, it appends (|h| / max |h| of the site, (site, index)) for every
    kinked pre-activation within 1e-5 of the site's largest of 0."""
    from gnn_tpu_torch.ops import fused
    from gnn_tpu_torch.ops.mlp import SELU_ALPHA, SELU_SCALE
    calls = [0]

    def grad(act, h):
        site = calls[0]
        calls[0] += 1
        g = fused._act_grad(act, h).flatten().clone()
        if act not in KINKED:
            return g.reshape(h.shape)
        hf = h.flatten()
        if record is not None:
            rel = hf.abs() / hf.abs().max().clamp_min(1e-30)
            for i in torch.nonzero(rel <= 1e-5).flatten().tolist():
                record.append((float(rel[i]), (site, i)))
        for s, i in flips:
            if s == site:        # h is within rounding of the kink
                g[i] = ((SELU_SCALE * SELU_ALPHA if hf[i] > 0 else SELU_SCALE)
                        if act == "selu" else float(hf[i] <= 0))
        return g.reshape(h.shape)
    return grad


def block_inputs(kern, x, b):
    """The inputs of block b alone (for K2, K15 and K17 its own adjacency as
    adj_loop)."""
    xb = dict(x)
    for k, axis in BWD2[kern][3].items():
        if x.get(k) is not None:
            xb[k] = x[k].narrow(axis, b, 1).contiguous()
    if kern in ("K2", "K15", "K17"):
        Bl = loop_rows(x)
        xb["adj_loop"] = x["adj_loop"][b:b + 1] if b < Bl else x["adj_dep"][b - Bl:b - Bl + 1]
        xb["adj_dep"] = None
    return xb


def replica(torch, kern, xb, flips=(), record=None):
    """The plain version of the reverse kernel `kern` in float64 on xb, with
    act_grad_hook's derivative; float32 outputs."""
    import importlib
    mod, name = BWD2[kern][:2]
    fn = getattr(importlib.import_module(f"gnn_tpu_torch.ops.{mod}"), name + "_ref")
    x64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in xb.items()}
    out = fn(**x64, act_grad=act_grad_hook(torch, flips, record))
    return [None if t is None else t.float() for t in out]


def check_bwd2(torch, kern, x, label):
    """A reverse kernel with a kinked activation's derivative (K2, K8, the
    two-layer K11, K13, K15, and K17) against its plain version.
    Where the activations have kinks (selu, relu), a pre-activation within
    rounding of 0 lets two summation orders take different, equally valid
    derivative branches (gnn_tpu's adjudication, docs/kernels.md:241-249),
    and one such unit moves a block's cotangents by up to ~1e-2. A block that
    differs from the plain version is therefore accepted only if the float64
    replica of the plain version with the derivative branch switched at none
    or some of its near-kink units (at most 8, every subset tried; none: the
    plain version took the other branch) reproduces the kernel's outputs on
    that block within TOL (per node) and SUM_RTOL (its partials); every other
    block is held to the plain version. A second launch must be bit-identical
    to the first. Returns the largest per-node difference over the blocks held
    to the plain version."""
    import importlib
    import itertools
    mod, name, outs, _ = BWD2[kern]
    module = importlib.import_module(f"gnn_tpu_torch.ops.{mod}")
    got, want = against_plain(torch, module, name, x)
    again = getattr(module, name)(**x)
    if not all(a is None or bool(torch.equal(a, b)) for a, b in zip(got, again)):
        fail(f"{kern} {label}: a second launch is not bit-identical to the first")
    B = got[0].shape[0]

    def block_err(g, w):
        """Largest per-node difference and whether the partials agree, per block."""
        node = torch.zeros(g[0].shape[0], device=g[0].device)
        part_ok = torch.ones(g[0].shape[0], dtype=torch.bool, device=g[0].device)
        for (_, axis, kind), a, b in zip(outs, g, w):
            if a is None:
                continue
            err = (a - b).abs().movedim(axis, 0).flatten(1)
            if kind == "node":
                node = torch.maximum(node, err.amax(1))
            else:
                bmag = b.abs().movedim(axis, 0).flatten(1)
                part_ok &= (err <= SUM_RTOL * (bmag + bmag.amax(1, keepdim=True))).all(1)
        return node, part_ok
    for (oname, _, _), t in zip(outs, got):
        if t is not None and not bool(torch.isfinite(t).all()):
            fail(f"{kern} {label}: non-finite {oname}")
    node, part_ok = block_err(got, want)
    bad = torch.nonzero((node > TOL) | ~part_ok).flatten().tolist()
    if len(bad) > max(2, B // 100):
        fail(f"{kern} {label}: {len(bad)} of {B} blocks disagree with the plain version "
             f"(largest per-node difference {float(node.max()):.3e})")
    ref = [None if w is None else w.clone() for w in want]
    flipped = 0
    for b in bad:
        xb = block_inputs(kern, x, b)
        gb_ = [None if t is None else t.narrow(axis, b, 1) for (_, axis, _), t in zip(outs, got)]
        cands = []
        replica(torch, kern, xb, record=cands)
        cands = [pos for _, pos in sorted(cands)[:8]]
        for flips in itertools.chain.from_iterable(
                itertools.combinations(cands, r) for r in range(len(cands) + 1)):
            rep = replica(torch, kern, xb, flips)
            n_err, p_ok = block_err(gb_, rep)
            if float(n_err[0]) <= TOL and bool(p_ok[0]):
                break
        else:
            fail(f"{kern} {label}: block {b} differs from the plain version by "
                 f"{float(node[b]):.3e} and no derivative branch switch at its "
                 f"{len(cands)} near-kink units explains it")
        flipped += len(flips)
        for (_, axis, _), r, t in zip(outs, ref, rep):
            if r is not None:
                r.narrow(axis, b, 1).copy_(t)
    worst = float(node[[i for i in range(B) if i not in bad]].max()) if len(bad) < B else 0.0
    sums = [f"{oname} {close_sum(torch, a.sum(0), r.sum(0), f'{kern} {label} {oname}'):.3e}"
            for (oname, _, kind), a, r in zip(outs, got, ref) if kind == "part" and a is not None]
    say(f"{kern} {label}: repeat bit-identical; max per-node difference {worst:.3e} on "
        f"{B - len(bad)} blocks, summed "
        + ", ".join(sums)
        + (f"; {len(bad)} blocks take another derivative branch at {flipped} near-kink units, "
           f"which the float64 replica reproduces within {TOL:g}" if bad else ""))
    return worst


def check_two_layer(torch, k9, k10, k12, k13, label, k11=None):
    """K9/K10/K12/K13 (and K11 given its operands) against their plain
    versions. Returns their largest per-node differences."""
    from gnn_tpu_torch.ops import fused2

    def run(name, x):
        return against_plain(torch, fused2, name, x)
    B, W, D = k12["s0"].shape
    shape = (f"B={B} W={W} D={D} AL={k12['fd'].shape[-1]} H1={k12['w0'].shape[0]} "
             f"K={k12['K']} {k12['act0']}/{k12['act1']} rate={k12['rate']}")
    got9, want9 = run("propagation_step2", k9)
    return {
        "K9": check_plain(torch, f"K9 {label} (Bd={k9['adjT'].shape[0]}, "
                          f"H1={k9['w0'].shape[0]}, res={k9['rT'] is not None})",
                          (got9,), (want9,), ("out",)),
        "K10": check_plain(torch, f"K10 {label} (Bl={k10['adjT'].shape[0]}, "
                           f"H1={k10['w0'].shape[0]}, affine={k10['affine'] is not None})",
                           *run("propagation_loop2", k10), ("traj", "margins"),
                           exact=("margins",)),
        "K12": check_plain(torch, f"K12 {label} ({shape})", *run("train_loop2", k12),
                           ("traj", "margins", "agg"), exact=("margins",)),
        "K13": check_bwd2(torch, "K13", k13, f"{label} ({shape})"),
        **({} if k11 is None else {"K11": check_bwd2(
            torch, "K11", k11, f"{label} (B={B} W={W} D={D} AL={k11['feats'].shape[-1]} "
            f"H1={k11['w0'].shape[0]} K={k11['traj'].shape[0]} {k11['act0']}/{k11['act1']} "
            f"affine={k11['affine'] is not None})")}),
    }


def _dims2(x, f):
    """(B, W, D, AL, H1, nodes, weight bytes, adjacency bytes, arcs) of the
    two-layer kernels' operands x, AL the width of x[f]."""
    B, W, D = x["adjT"].shape[0], x["adjT"].shape[1], x["w1"].shape[0]
    H1, AL = x["w0"].shape[0], x[f].shape[-1]
    wts = 4 * (H1 * (2 * D + AL) + H1 + D * H1 + D)
    return B, W, D, AL, H1, B * W, wts, 4 * x["adjT"].numel(), _nnz(x["adjT"])


def two_layer_bounds(k9, k10, k12, k13):
    """(K9, K10, K12, K13) least times and what sets them: each input read
    once, each output written once; the operations the function needs: the
    dense layers (2*H1*(3D + AL) a node and iteration forward; backward the
    forward again, the reverse layers and the weight sums, 2*H1*(9D + 3AL + 1)),
    the arcs present (2*D each) and the elementwise work."""
    f4 = 4
    dims = _dims2
    B, W, D, AL, H1, n, wts, adj, nnz = dims(k9, "feats")
    res = 0 if k9["rT"] is None else f4 * n * D
    bytes9 = adj + f4 * n * (D + AL) + res + wts + f4 * 2 * D + f4 * n * D
    flops9 = 2 * D * nnz + n * (2 * H1 * (3 * D + AL) + 4 * H1 + 6 * D)
    B, W, D, AL, H1, n, wts, adj, nnz = dims(k10, "feats")
    K = k10["K"]
    bytes10 = (adj + f4 * n * (D + AL + 1) + wts + f4 * 2 * D + f4 * K * n * (D + 1))
    flops10 = K * (2 * D * nnz + n * (2 * H1 * (3 * D + AL) + 4 * H1 + 10 * D))
    B, W, D, AL, H1, n, wts, adj, nnz = dims(k12, "fd")
    K = k12["K"]
    masks = 0 if k12["ms"] is None else 2 * K * n * D
    bytes12 = (adj + f4 * n * (D + 1) + f4 * K * n * AL + masks + wts
               + f4 * K * n * (2 * D + 1))
    flops12 = K * (2 * D * nnz + n * (2 * H1 * (3 * D + AL) + 4 * H1 + 12 * D))
    B, W, D, AL, H1, n, wts, adj, nnz = dims(k13, "fd")
    K = k13["traj"].shape[0]
    bytes13 = (adj + f4 * n * D + f4 * (K - 1) * n * D + f4 * 2 * K * n * D + f4 * K * n * AL
               + masks + wts + f4 * n * D + B * wts + f4 * K * n * AL)
    flops13 = K * (2 * D * nnz + n * (2 * H1 * (9 * D + 3 * AL + 1) + 8 * H1 + 16 * D))
    return (bound(bytes9, flops9), bound(bytes10, flops10), bound(bytes12, flops12),
            bound(bytes13, flops13))


def two_layer_train_kernel_inputs(torch, gb, width=14):
    """K11's operands as the 'h150_clean' route forms them on the training
    batch (the plain K10's trajectory, a readout-like cotangent), K14's of
    iteration 2 and K15's of its reverse as the 'h150_bn' route forms them
    (train_kernel_inputs); the routes at node-label width `width`."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused2
    model = flagship(torch, "cuda", f"w{width}_h150_clean")
    spec = model.spec
    acts = dict(zip(("act0", "act1"), spec.state_spec.activations))
    with torch.no_grad():
        loop, _ = core.hybrid2_operands(spec, model.params["state"], model.bn["state"], gb)
        traj, _ = fused2.propagation_loop2_ref(**loop, K=spec.max_iteration,
                                               threshold=float(spec.threshold), **acts)
        k11 = dict(adjT=loop["adjT"], s0=loop["s0"], traj=traj, feats=loop["feats"],
                   w0=loop["w0"], b0=loop["b0"], w1=loop["w1"], b1=loop["b1"], affine=None,
                   g_traj=readout_like(torch, traj, loop["nm"], SEED + 12), **acts)
    (_, x14), kw14, x15, kw15 = train_kernel_inputs(torch, flagship(torch, "cuda",
                                                                     f"w{width}_h150_bn"), gb)
    return k11, x14, kw14, dict(x15, **kw15)


def two_layer_train_bounds(k11, x14, x15):
    """(K11, K14, K15) least times and what sets them: each input read once,
    each output written once; the operations the function needs: K11 the
    K reverse steps of K13's count with the aggregation again (4*D per arc);
    K14 the dense layers 2*H1*(3D + F) a node, K15 their reverse with the
    forward again, the bias-augmented weight sums and the state and
    aggregation columns of dx3 (K15 returns no feats cotangent),
    2*H1*(9D + 2F + 1); the arcs present (2*D each) and the elementwise
    work."""
    f4 = 4
    B, W, D, AL, H1, n, wts, adj, nnz = _dims2(k11, "feats")
    K = k11["traj"].shape[0]
    aff = 0 if k11["affine"] is None else f4 * (2 * D + B * 2 * D)
    bytes11 = (adj + f4 * n * D + f4 * (K - 1) * n * D + f4 * n * AL + wts + f4 * K * n * D
               + f4 * n * D + B * wts + f4 * n * AL + aff)
    flops11 = K * (4 * D * nnz + n * (2 * H1 * (9 * D + 3 * AL + 1) + 8 * H1 + 16 * D))
    adjs = [a for a in (x14["adj_loop"], x14["adj_dep"]) if a is not None]
    nnz = sum(_nnz(a) for a in adjs)
    R, W, D = x14["y1"].shape
    F = x14["feats"].shape[-1]
    H1 = x14["w0_aug"].shape[0]
    C = 2 * D + F + 1
    n = R * W
    wts = f4 * (H1 * C + D * H1 + D)
    keep_b = 0 if x14["keep"] is None else n * (C - 1)
    shared = f4 * sum(a.numel() for a in adjs) + keep_b + f4 * (n * F + n) + wts
    rt_b = 0 if x14["rT"] is None else f4 * n * D
    bytes14 = shared + f4 * (2 * n * D + 4 * D) + rt_b + f4 * (2 * n * D + n + R * D)
    flops14 = 2 * D * nnz + n * (2 * H1 * (3 * D + F) + 6 * H1 + 14 * D)
    bytes15 = (shared + f4 * (5 * n * D + 9 * D + 1)
               + f4 * (2 * n * D + R * (H1 * C + D * H1 + D) + 2 * R * D))
    flops15 = 2 * D * nnz + n * (2 * H1 * (9 * D + 2 * F + 1) + 10 * H1 + 20 * D)
    return bound(bytes11, flops11), bound(bytes14, flops14), bound(bytes15, flops15)


def phase_two_layer_train_kernels(torch, gb):
    """K11 at the 'h150_clean' route's training shapes (with and without an
    affine), K14/K15 at the 'h150_bn' route's, and K14/K15 at ragged shapes
    of each register width (16, 32, 64), at the hidden-width cap and with an
    arc-label width above 16; against their plain versions; times and bounds
    at the full set."""
    from gnn_tpu_torch.ops import bn, fused2
    k11, x14, kw14, x15 = two_layer_train_kernel_inputs(torch, gb)
    dev = gb.device
    gen = torch.Generator().manual_seed(SEED + 13)
    D = k11["s0"].shape[-1]
    shape = f"Bl={k11['adjT'].shape[0]} H1={k11['w0'].shape[0]}"
    errs = {"K11": check_bwd2(torch, "K11", k11, f"full set ({shape})")}
    aff = torch.stack([torch.rand(D, generator=gen) + 0.5, 0.1 * torch.randn(D, generator=gen)])
    check_bwd2(torch, "K11", dict(k11, affine=aff.to(dev)), f"full set ({shape}), affine")
    errs["K14"] = check_bn_forward(torch, bn, x14, kw14, "full set, iteration 2")
    errs["K15"] = check_bwd2(torch, "K15", x15, f"full set, reverse of iteration 2 "
                             f"(R={x15['y_prev'].shape[0]} H1={x15['w0_aug'].shape[0]})")
    for R, Bl, W, D, F, H1, acts, alpha, rate, res in (
            (6, 4, 32, 5, 3, 16, ("selu", "tanh"), True, 0.1, True),
            (5, 5, 96, 14, 3, 37, ("tanh", "relu"), False, 0.2, True),
            (4, 2, 128, 14, 3, 150, ("selu", "selu"), True, 0.1, True),
            (3, 3, 128, 14, 3, fused2.MAX_HIDDEN, ("selu", "selu"), True, 0.0, False),
            (4, 1, 64, 64, 3, 16, ("relu", "linear"), False, 0.1, True),
            (3, 2, 32, 5, 20, 37, ("tanh", "tanh"), True, 0.1, True)):
        f, b = random_bn_inputs(torch, gen, R, Bl, W, D, F, rate, res, dev, H1=H1)
        k = dict(act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate)
        check_bn_forward(torch, bn, f, dict(k, threshold=0.05), "ragged")
        check_bwd2(torch, "K15", dict(b, **k), f"ragged (R={R} Bl={Bl} W={W} D={D} F={F} "
                   f"H1={H1} {acts[0]}/{acts[1]} rate={rate})")
    # the tiled K11, K14 and K15 on the full set: a repeat bit-identical, the
    # occupancy, and each plan that fits forced and timed
    plans_ms = {}
    for k, kernel, x, dims in (
            ("K11", fused2.propagation_loop2_bwd, k11,
             (k11["adjT"].shape[1], k11["s0"].shape[-1], k11["feats"].shape[-1],
              k11["w0"].shape[0])),
            ("K14", bn.bn2_forward_step, dict(x14, **kw14),
             (x14["adj_loop"].shape[1], x14["y1"].shape[-1], x14["feats"].shape[-1],
              x14["w0_aug"].shape[0])),
            ("K15", bn.bn2_backward_step, x15,
             (x15["adj_loop"].shape[1], x15["y_prev"].shape[-1], x15["feats"].shape[-1],
              x15["w0_aug"].shape[0]))):
        first = check_tiled(torch, k, kernel, x, dims)
        plans_ms[k] = time_plans(torch, k, kernel, x, dims, first)
    out = {}
    for (k, mod, name, src, rep_, x, kw, rows), (b, by) in zip(
            (("K11", fused2, "propagation_loop2_bwd", "eval_loop2_bwd.cu", "pallas_fused.py:1390",
              k11, {}, "adjT"),
             ("K14", bn, "bn2_forward_step", "bn2_fwd.cu", "pallas_bn.py:568", x14, kw14, "y1"),
             ("K15", bn, "bn2_backward_step", "bn2_train.cu", "pallas_bn.py:677", x15, {},
              "y_prev")),
            two_layer_train_bounds(k11, x14, x15)):
        kernel, plain = getattr(mod, name), getattr(mod, name + "_ref")
        out[k] = dict(name=f"{k} {name}", route="cuda", source=f"gnn_tpu_torch/ops/csrc/{src}",
                      replaces=f"gnn_tpu/ops/{rep_}", max_abs_err=errs[k],
                      ms=timed_ms(torch, lambda: kernel(**x, **kw)),
                      plain_ms=timed_ms(torch, lambda: plain(**x, **kw)),
                      bound_ms=b, bound_by=by, library_ms=None)
        say(f"{k} timing at {rows} {tuple(x[rows].shape)}: kernel {out[k]['ms']:.4f} ms, plain "
            f"{out[k]['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})"
            + (f"; each plan forced: {plans_ms[k]}" if k in plans_ms else ""))
    return out


# the kernels with shared-memory plans: the register-tiled ones
# (ops/csrc/tile2.cuh; K9 in fused2.cu, K14 in bn2_fwd.cu), K1 (bn_fwd.cu),
# K2 (bn_train.cu), K3 (eval_loop.cu), K8 (train_loop_bwd.cu), K16 and K17
# (bn_typed.cu) and K5 (eval_loop_bwd.cu); a shape is (W, D, AL or F, H1),
# K16's and K17's (W, D, F, T), K1's and K2's H1 and K3's, K5's and K8's AL
# and H1 unused
TILED = ("K9", "K10", "K11", "K12", "K13", "K14", "K15", "K1", "K2", "K3", "K8", "K17", "K16",
         "K5")
# the kernels with plans of their own threads a CTA (the rest run 256)
PLAN_THREADS = ("K1", "K2", "K3", "K17", "K16", "K4", "K6", "K7")


def wide_layout(k, W, D, X, H1=0):
    """(shared-memory bytes, workspace floats a block row) of kernel k's wide
    plan (K1-K8; the plan after its staged plans) at (W, D, F or H or -), as
    ops/bn.py and ops/fused.py mirror it."""
    from gnn_tpu_torch.ops import bn, fused, fused2, typed
    if k in fused2._TILED:
        return fused2._tile2_wide(fused2._KIND[k], W, D, X, H1)
    return {"K1": lambda: bn._bn_fwd_wide(W, D, X), "K2": lambda: bn._bn_bwd_wide(W, D, X),
            "K3": lambda: fused._loop_wide(W, D), "K4": lambda: fused._step_wide(W, D, X),
            "K5": lambda: fused._loop_bwd_wide(W, D),
            "K6": lambda: fused._train_step_wide(W, D, X),
            "K7": lambda: fused._train_loop_wide(W, D),
            "K8": lambda: fused._train_bwd_wide(W, D),
            "K16": lambda: typed._bnT_fwd_wide(W, D, X, H1),
            "K17": lambda: typed._bnT_bwd_wide(W, D, X, H1)}[k]()


WIDE_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12",
                "K13", "K14", "K15", "K16", "K17")


def plan_kernel(k):
    """(plan list, layout bytes (W, D, AL, H1, plan), C entry) of kernel k, as
    ops/fused2.py, ops/bn.py, ops/fused.py or ops/typed.py mirror it (K1-K8's
    staged plans; their wide plans: wide_layout)."""
    import functools
    from gnn_tpu_torch.ops import bn, fused, fused2, typed
    if k in fused2._TILED:
        return (fused2._PLANS[k], functools.partial(fused2._tile2_bytes, fused2._KIND[k]),
                fused2._TILED[k])
    return {"K1": (bn._BN_FWD_PLANS, lambda W, D, F, H1, p: bn._bn_fwd_bytes(W, D, F, p),
                   "gnn_bn_forward"),
            "K2": (bn._BN_BWD_PLANS, lambda W, D, F, H1, p: bn._bn_bwd_bytes(W, D, F, p),
                   "gnn_bn_backward"),
            "K3": (fused._LOOP_PLANS, lambda W, D, AL, H1, p: fused._loop_bytes(W, D, p),
                   "gnn_propagation_loop"),
            # K4's third width is H, the state width it writes
            "K4": ((fused._STEP_PLAN,), lambda W, D, H, H1, p: fused._step_bytes(W, D, H),
                   "gnn_propagation_step"),
            "K7": ((fused._TRAIN_LOOP_PLAN,),
                   lambda W, D, AL, H1, p: fused._train_loop_bytes(W, D), "gnn_train_loop"),
            # K6's third width is H, the state width it writes
            "K6": ((fused._TRAIN_STEP_PLAN,),
                   lambda W, D, H, H1, p: fused._train_step_bytes(W, D, H), "gnn_train_step"),
            "K8": (fused._TRAIN_BWD_PLANS, lambda W, D, AL, H1, p: fused._train_bwd_bytes(W, D, p),
                   "gnn_train_loop_bwd"),
            "K17": (typed._BNT_BWD_PLANS, typed._bnT_bwd_bytes, "gnn_bnT_backward"),
            "K16": (typed._BNT_FWD_PLANS, typed._bnT_fwd_bytes, "gnn_bnT_forward"),
            "K5": (fused._LOOP_BWD_PLANS, lambda W, D, AL, H1, p: fused._loop_bwd_bytes(W, D, p),
                   "gnn_propagation_loop_bwd")}[k]


def plans_of(k):
    """Kernel k's plan list, as the Python mirror holds it."""
    return plan_kernel(k)[0]


def plan_bytes(k, plan, W, D, AL, H1):
    return int(plan_kernel(k)[1](W, D, AL, H1, plan))


def mirrored_plan(k, W, D, AL, H1):
    """(bytes, plan index or None) the Python mirror names for kernel k."""
    from gnn_tpu_torch.ops import fused, fused2, typed
    if k in fused2._TILED:
        return fused2._tile2_plan(W, D, AL, H1, k)
    if k in ("K16", "K17"):
        return (typed._bnT_fwd_plan if k == "K16" else typed._bnT_bwd_plan)(W, D, AL, H1)
    plans, nbytes, _ = plan_kernel(k)
    wide = (lambda *dims: wide_layout(k, *dims)) if k in WIDE_KERNELS else None
    return fused._first_plan(plans, nbytes, W, D, AL, H1, wide=wide)


def plan_info(k, W, D, AL, H1):
    """What the card reports for the plan kernel k takes at this shape."""
    from gnn_tpu_torch.ops import fused
    return fused._plan_info(plan_kernel(k)[2], W, D, AL, H1)


def tiled_plan(k, W, D, AL, H1):
    """The shared-memory plan the library takes for kernel k at this shape,
    held equal to the Python mirror's (ops/fused2.py::_tile2_plan,
    ops/bn.py::_bn_plan, ops/fused.py::_loop_plan, _loop_bwd_plan,
    _train_bwd_plan, _step_bytes, _train_step_bytes and _train_loop_bytes,
    ops/typed.py::_bnT_fwd_plan
    and _bnT_bwd_plan), and what the card reports for it."""
    info = plan_info(k, W, D, AL, H1)
    need, plan = mirrored_plan(k, W, D, AL, H1)
    if (info["plan"], info["smem_bytes"]) != (plan, need):
        fail(f"{k} W={W} D={D} AL={AL} H1={H1}: the library takes plan {info['plan']} "
             f"({info['smem_bytes']} bytes), the Python mirror says {plan} ({need} bytes)")
    return info


def describe_k(k, info):
    """Kernel k's plan and occupancy as the card reports them (info)."""
    plans = plans_of(k)
    threads = (plans[info["plan"]][0] if k in PLAN_THREADS and info["plan"] < len(plans)
               else 256)
    return (f"plan {info['plan']}, {info['smem_bytes']} bytes of shared memory a CTA, "
            f"{info['ctas_per_sm']} CTAs ({info['ctas_per_sm'] * threads // 32} warps) an SM, "
            f"{info['registers']} registers and {info['local_bytes']} local bytes a thread")


def check_repeat(torch, k, kernel, x, label):
    """A second launch of kernel k bit-identical to the first."""
    first, again = kernel(**x), kernel(**x)
    torch.cuda.synchronize()
    if not all(a is None or bool(torch.equal(a, b)) for a, b in zip(first, again)):
        fail(f"{k} {label}: a second launch is not bit-identical to the first")


def check_tiled(torch, k, kernel, x, dims):
    """A kernel with plans on the full set: a second launch bit-identical to
    the first; the plan and the occupancy the card reports. Returns the first
    launch's outputs."""
    first = kernel(**x)
    again = kernel(**x)
    torch.cuda.synchronize()
    if not all(a is None or bool(torch.equal(a, b)) for a, b in zip(first, again)):
        fail(f"{k}: a second launch on the full set is not bit-identical to the first")
    say(f"{k} full set: second launch bit-identical; {describe_k(k, tiled_plan(k, *dims))}")
    return first


def check_plans(torch, k, kernel, x, dims, label):
    """Kernel k (K3, K4, K6, K7, K9, K16, K5) at a shape: a second launch and each plan that
    fits, forced in turn (K4, K6 and K7 have one staged plan; phase 18 forces the wide
    plans), bit-identical to the first launch; the plan the library takes held to the
    mirror's."""
    from gnn_tpu_torch.ops import fused2
    info = tiled_plan(k, *dims)
    first = kernel(**x)
    runs = {"a second launch": kernel(**x)}
    if len(plans_of(k)) > 1:
        force = force_entry(k)
        try:
            for i, plan in enumerate(plans_of(k)):
                if plan_bytes(k, plan, *dims) <= fused2.SMEM_BYTES:
                    force(i)
                    runs[f"plan {i} forced"] = kernel(**x)
        finally:
            force(-1)
    torch.cuda.synchronize()
    for what, got in runs.items():
        if not all(a is None or bool(torch.equal(a, b)) for a, b in zip(got, first)):
            fail(f"{k} {label}: {what} is not bit-identical to the first launch (plan "
                 f"{info['plan']})")
    say(f"{k} {label}: {', '.join(runs)} bit-identical to the first launch (plan {info['plan']})")


def step_out(**x):
    """K4's wrapper with its one output as a tuple, as the plan checks take it."""
    from gnn_tpu_torch.ops import fused
    return (fused.propagation_step(**x),)


def step2_out(**x):
    """K9's wrapper with its one output as a tuple, as the plan checks take it."""
    from gnn_tpu_torch.ops import fused2
    return (fused2.propagation_step2(**x),)


def force_entry(k):
    """Kernel k's gnn_*_force_plan entry."""
    from gnn_tpu_torch.ops import _build
    return getattr(_build.library(), plan_kernel(k)[2] + "_force_plan")


def time_plans(torch, k, kernel, x, dims, first):
    """Every plan of K3, K9, K11, K12, K14, K15, K1, K2, K8, K17, K16 or K5 that fits
    the full-set shape, forced in turn (its outputs bit-identical to the
    default plan's `first`), timed as the kernels' rows are; the plan list is
    ordered by these times."""
    from gnn_tpu_torch.ops import fused2
    force = force_entry(k)
    times = {}
    try:
        for i, plan in enumerate(plans_of(k)):
            if plan_bytes(k, plan, *dims) > fused2.SMEM_BYTES:
                continue
            force(i)
            got = kernel(**x)
            torch.cuda.synchronize()
            if not all(a is None or bool(torch.equal(a, b)) for a, b in zip(got, first)):
                fail(f"{k}: plan {i} is not bit-identical to plan "
                     f"{mirrored_plan(k, *dims)[1]} on the full set")
            times[i] = timed_ms(torch, lambda: kernel(**x))
            info = plan_info(k, *dims)
            say(f"{k} full set, plan {i} forced: {times[i]:.4f} ms, bit-identical to the default "
                f"plan; {describe_k(k, info)}")
    finally:
        force(-1)
    return times


def phase_two_layer_kernels(torch, gb, gb_train):
    """K9/K10 at the h150 serving path's full-set shapes, K12/K13 at its
    training shapes, and all four and K11 at ragged shapes of each register width
    (16, 32, 64), at the wrappers' hidden-width cap and with an arc-label
    width above D; against their plain versions; times and bounds at the
    full set."""
    from gnn_tpu_torch.ops import bn, fused2
    k9, k10, k12, k13 = two_layer_kernel_inputs(torch, gb, gb_train)
    errs = check_two_layer(torch, k9, k10, k12, k13, "full set")
    plans_ms = {}
    for k, kernel, x, f in (("K9", step2_out, k9, "feats"),
                            ("K10", fused2.propagation_loop2, k10, "feats"),
                            ("K12", fused2.train_loop2, k12, "fd"),
                            ("K13", fused2.train_loop2_bwd, k13, "fd")):
        dims = (x["adjT"].shape[1], x["w1"].shape[0], x[f].shape[-1], x["w0"].shape[0])
        first = check_tiled(torch, k, kernel, x, dims)
        if k in ("K9", "K12"):
            plans_ms[k] = time_plans(torch, k, kernel, x, dims, first)
        if k == "K9":   # and without the residual term
            x9 = dict(x, rT=None)
            got, want = against_plain(torch, fused2, "propagation_step2", x9)
            check_plain(torch, f"K9 full set (Bd={x['adjT'].shape[0]}, H1={x['w0'].shape[0]}, "
                        "res=False)", (got,), (want,), ("out",))
            check_plans(torch, "K9", step2_out, x9, dims, "full set, res=False")
    # the plans the cases take (K11, K14, K15 and K2 take plan 0 at the full
    # set, phases 5 and 8; K1's and K3's cases are phase 5's and 3's, K8's
    # and K5's phase 6's, K16's and K17's phase 10's)
    two = [k for k in TILED if k not in ("K1", "K3", "K8", "K17", "K16", "K5")]
    reached = {k: set() for k in two}
    reached.update(K9={0}, K10={0}, K12={0}, K13={0})

    def reach(W, D, AL, H1, kernels=two):
        for k in kernels:
            if mirrored_plan(k, W, D, AL, H1)[1] is not None:   # K2 runs where a plan fits
                reached[k].add(tiled_plan(k, W, D, AL, H1)["plan"])

    gen = torch.Generator().manual_seed(SEED + 11)
    for B, W, D, AL, H1, K, acts, rate, alpha in (
            (5, 32, 5, 3, 16, 3, ("selu", "tanh"), 0.2, True),
            (3, 96, 14, 3, 37, 4, ("tanh", "relu"), 0.15, False),
            (3, 64, 14, 3, 150, 3, ("selu", "selu"), 0.1, True),
            (2, 128, 14, 3, fused2.MAX_HIDDEN, 2, ("selu", "selu"), 0.0, True),
            (2, 32, 5, 20, 16, 2, ("relu", "tanh"), 0.1, False),
            (2, 128, 64, 3, 16, 2, ("relu", "linear"), 0.1, True),
            (2, 96, 64, 5, 37, 2, ("tanh", "tanh"), 0.1, False)):
        *x, k11 = random_two_layer_inputs(torch, gen, B, W, D, AL, H1, K, acts, rate, alpha,
                                          gb.device)
        check_two_layer(torch, *x, "ragged", k11)
        reach(W, D, AL, H1, [k for k in two if k not in ("K2", "K14")])
    # the register-tiled K10, K11, K12, K13 and K15 at the edges of their
    # tiling (K15 with a dep row), and K2 at the same widths (W, D, F = AL)
    # with a dep row and a row of 40 arcs in every block; the last two take
    # the leanest plans, the last one at a shape only they fit
    for B, W, D, AL, H1, K, acts, rate, alpha, dense in (
            (3, 128, 14, 3, 1, 3, ("selu", "selu"), 0.1, True, False),
            (3, 128, 14, 3, 7, 3, ("tanh", "selu"), 0.1, False, False),
            (3, 96, 14, 3, 33, 3, ("selu", "tanh"), 0.2, True, False),
            (2, 128, 14, 3, 512, 3, ("selu", "selu"), 0.1, True, False),
            (4, 32, 1, 1, 16, 3, ("tanh", "tanh"), 0.1, False, False),
            (2, 64, 64, 64, 150, 2, ("selu", "tanh"), 0.1, True, False),
            (3, 128, 14, 3, 150, 3, ("selu", "selu"), 0.1, True, True),
            (2, 128, 64, 33, 150, 2, ("selu", "tanh"), 0.0, True, False),
            (2, 32, 15, 59, 511, 2, ("tanh", "selu"), 0.1, False, False)):
        k9r, k10r, k12r, k13r, k11r = random_two_layer_inputs(
            torch, gen, B, W, D, AL, H1, K, acts, rate, alpha, gb.device, dense=dense)
        k14r, k15r = random_bn_inputs(torch, gen, B + 1, B, W, D, AL, rate, True, gb.device,
                                      H1=H1, dense=dense)
        label = (f"tiling edge (B={B} W={W} D={D} AL={AL} H1={H1} K={K} {acts[0]}/{acts[1]} "
                 f"rate={rate}{' dense adjacency' if dense else ''})")
        kw14 = dict(act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate, threshold=0.05)
        if W == 96:     # the all-dep layout: no loop rows (Bl = 0, adj_loop None)
            k14r = dict(k14r, adj_loop=None,
                        adj_dep=torch.cat([k14r["adj_loop"], k14r["adj_dep"]]).contiguous())
        check_bn_forward(torch, bn, k14r, kw14, label)
        check_repeat(torch, "K14", bn.bn2_forward_step, dict(k14r, **kw14), label)
        if H1 == 7:     # K9 with a destination of 40 arcs: read from device memory
            k9r = dict(k9r, adjT=k9r["adjT"].clone())
            k9r["adjT"][:, :40, 5] = 0.05
        for x9 in (k9r, dict(k9r, rT=None)):
            got, want = against_plain(torch, fused2, "propagation_step2", x9)
            what = f"{label}, res={x9['rT'] is not None}"
            check_plain(torch, f"K9 {what}", (got,), (want,), ("out",))
            check_plans(torch, "K9", step2_out, x9, (W, D, AL, H1), what)
        check_plain(torch, f"K10 {label}", *against_plain(torch, fused2, "propagation_loop2", k10r),
                    ("traj", "margins"), exact=("margins",))
        check_plain(torch, f"K12 {label}", *against_plain(torch, fused2, "train_loop2", k12r),
                    ("traj", "margins", "agg"), exact=("margins",))
        check_repeat(torch, "K12", fused2.train_loop2, k12r, label)
        if bn._bn_bwd_plan(W, D, AL)[1] is not None:
            _, k2r = random_bn_inputs(torch, gen, B + 1, B, W, D, AL, rate, True, gb.device,
                                      dense=dense)
            k2r["adj_loop"][:, 3, :40] = 0.05   # a row of 40 arcs: read from device memory
            check_bn_backward(torch, k2r, dict(activation=acts[0], alpha_drop=alpha, rate=rate),
                              f"tiling edge ({'dense adjacency, ' if dense else ''}a 40-arc row)")
        check_bwd2(torch, "K13", k13r, label)
        x15 = dict(k15r, act0=acts[0], act1=acts[1], alpha_drop=alpha, rate=rate)
        check_bwd2(torch, "K11", k11r, f"{label}, affine")
        check_bwd2(torch, "K15", x15, f"{label}, R={B + 1} Bl={B}")
        reach(W, D, AL, H1)
    for k in two:
        if reached[k] != set(range(len(plans_of(k)))):
            fail(f"{k}: the cases reach plans {sorted(reached[k])} of its {len(plans_of(k))}")
    say("tiled plans reached: " + ", ".join(f"{k} {sorted(reached[k])}" for k in two))
    out = {}
    for (k, name, src, line), x, (b, by) in zip(
            (("K9", "propagation_step2", "fused2.cu", 1147),
             ("K10", "propagation_loop2", "loop2.cu", 1286),
             ("K12", "train_loop2", "loop2.cu", 1551),
             ("K13", "train_loop2_bwd", "train_loop2_bwd.cu", 1696)), (k9, k10, k12, k13),
            two_layer_bounds(k9, k10, k12, k13)):
        kernel, plain = getattr(fused2, name), getattr(fused2, name + "_ref")
        # K9 on the 110 dep rows is launch-sized: CUDA events over back-to-back
        # calls time the host's dispatch there, so its row takes the profiler's
        # device time a call (as K18's), the event times printed beside it
        timer = device_ms if k == "K9" else timed_ms
        out[k] = dict(name=f"{k} {name}", route="cuda", source=f"gnn_tpu_torch/ops/csrc/{src}",
                      replaces=f"gnn_tpu/ops/pallas_fused.py:{line}", max_abs_err=errs[k],
                      ms=(device_ms(torch, lambda: kernel(**x), 1) if k == "K9"
                          else timed_ms(torch, lambda: kernel(**x))),
                      plain_ms=timer(torch, lambda: plain(**x)),
                      bound_ms=b, bound_by=by, library_ms=None)
        events = (f" (device time a call; CUDA events: kernel {timed_ms(torch, lambda: kernel(**x)):.4f}"
                  f" ms, plain {timed_ms(torch, lambda: plain(**x)):.4f} ms)" if k == "K9" else "")
        say(f"{k} timing at adjT {tuple(x['adjT'].shape)}: kernel {out[k]['ms']:.4f} ms, plain "
            f"{out[k]['plain_ms']:.4f} ms{events}, bound {b:.4f} ms ({by})"
            + (f"; each plan forced: {plans_ms[k]}" if k in plans_ms else ""))
    return out


N_TYPES = 4      # node types of the composite paths


def typed_graphs(graphs, T=N_TYPES):
    """The graphs with node types drawn as benchmarks/composite_bench.py:107-119
    draws them: default_rng(7), integers(0, T, n_nodes) per graph in order."""
    import numpy as np
    from gnn_tpu_torch import Graph
    rng = np.random.default_rng(7)
    return [Graph(g.arcs, g.nodes, g.targets, focus=g.focus, set_mask=g.set_mask,
                  output_mask=g.output_mask, sample_weights=g.sample_weights,
                  node_graph=g.NodeGraph, aggregation_mode=g.aggregation_mode,
                  node_types=rng.integers(0, T, g.n_nodes).astype(np.int32)) for g in graphs]


def composite_model(torch, device, T=N_TYPES, width=14, optimizer="adam", act="selu", state=0):
    """The composite flagship: CompositeGNNgraphBased with T copies of the
    flagship's state net (31 -> 14, selu, AlphaDropout 0.1 at its input, the
    trailing BatchNorm; `width` in place of 14; a separate state of width
    `state` if > 0), the flagship's softmax readout, K=5, threshold 0.01,
    seeded random weights and non-trivial per-type moving statistics."""
    from gnn_tpu_torch import CompositeGNNgraphBased
    ref = flagship(torch, "cpu", f"s{state}_w{width}_{'tanh_' if act == 'tanh' else ''}bn")
    model = CompositeGNNgraphBased((ref.spec.state_spec,) * T, ref.spec.output_spec,
                                   optimizer=optimizer, max_iteration=5, threshold=0.01,
                                   seed=SEED, device=device, state_dim=state)
    gen = torch.Generator().manual_seed(SEED + 21)
    d = ref.spec.state_spec.units[-1]
    model.bn["state"] = tuple({"mean": (0.1 * torch.randn(d, generator=gen)).to(device),
                               "var": (0.5 + torch.rand(d, generator=gen)).to(device)}
                              for _ in range(T))
    return model


def tree_map(fn, tree):
    """fn over the tensors of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def typed_kernel_inputs(torch, model, gb, gb_serve):
    """K16's operands of iterations 1 and 2 and K17's of the reverse of
    iteration 2 as the composite training step forms them on the full set
    (per-type masks from a seeded generator, a readout-like state
    cotangent), and K16's of the composite serving path's second iteration
    (rate 0, the per-type inference affine). On bf16 batches the operands
    come from the bf16 variants' plain versions (K16_bf16/K17_bf16's), the
    serving affine in float64 rounded once, as the bf16 eval forms it."""
    from gnn_tpu_torch.models import composite
    from gnn_tpu_torch.ops import bn, typed
    dev = gb.device
    spec, ps = model.spec, model.params["state"]
    masks = composite.draw_masks(spec, gb, torch.Generator(device=dev).manual_seed(SEED + 22))
    with torch.no_grad():
        s0, w_stk, op = typed.typed_operands(spec, ps, gb, True, [m[0] for m in masks["state"]])
        fwd = typed.bnT_forward_step_bf16_ref if op.bf16 else typed.bnT_forward_step_ref
        gamma = torch.stack([p["bn"]["gamma"] for p in ps])
        beta = torch.stack([p["bn"]["beta"] for p in ps])
        T, D = op.n_types, s0.shape[-1]
        ident = bn._ident_aff(D, s0)[:, None].expand(2, T, D)
        nm3 = op.nm[..., None]
        cnt = op.type_sum(nm3).clamp_min(1.0)
        kw = dict(op.step_kw(), threshold=op.threshold)
        x0 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y1=s0, y2=torch.ones_like(s0),
                  aff=torch.stack([ident, ident]), types=op.types, keep=op.keep_k(0),
                  rT=bn._res_term(s0, ident, op.res, op), feats=op.feats, w_stk=w_stk, nm=op.nm)
        y0, _, _, _ = fwd(**x0, **kw)

        def moments(y):
            m = op.type_sum(y * nm3) / cnt
            v = op.type_sum((y - op.sel(m)) ** 2 * nm3) / cnt
            return m, torch.rsqrt(v + 1e-3), bn._affine(gamma, beta, m, v)

        m0, r0, a0 = moments(y0)
        x1 = dict(x0, y1=y0, y2=s0, aff=torch.stack([a0, ident]), keep=op.keep_k(1),
                  rT=bn._res_term(y0, a0, op.res, op))
        y1, agg1, _, _ = fwd(**x1, **kw)
        m1, r1, _ = moments(y1)
        g = torch.Generator(device=dev).manual_seed(SEED + 23)
        gsel = 0.03 * torch.randn(y1.shape, generator=g, device=dev) * nm3
        s1 = op.type_sum(gsel)
        s2 = op.type_sum(gsel * (y1 - op.sel(m1)) * op.sel(r1))
        a = gamma * r1
        bnv = torch.stack([a0[0], a0[1], m1, r1, a, a * s1 / cnt, a * s2 / cnt, m0, r0], dim=1)
        x2 = dict(adj_loop=op.adj_loop, adj_dep=op.adj_dep, y_prev=y0, y_k=y1, agg=agg1,
                  types=op.types, keep=op.keep_k(1), feats=op.feats, w_stk=w_stk,
                  ds_in=0.01 * torch.randn(y1.shape, generator=g, device=dev), gsel=gsel,
                  bnv=bnv.contiguous(), flag=torch.tensor(1.0, device=dev), nm=op.nm)
        # serving: the second iteration, from the first with the identity affine
        se0, sw, sop = typed.typed_operands(spec, ps, gb_serve, False)
        aff1 = torch.stack([bn._affine(p["bn"]["gamma"], p["bn"]["beta"], b["mean"], b["var"],
                                       sop.bf16)
                            for p, b in zip(ps, model.bn["state"])], dim=1)
        ev = dict(adj_loop=sop.adj_loop, adj_dep=sop.adj_dep, y1=se0, y2=torch.ones_like(se0),
                  aff=torch.stack([ident, ident]), types=sop.types, keep=None,
                  rT=bn._res_term(se0, ident, sop.res, sop), feats=sop.feats, w_stk=sw, nm=sop.nm)
        kwe = dict(sop.step_kw(), threshold=sop.threshold)
        ye, _, _, _ = fwd(**ev, **kwe)
        ev = dict(ev, y1=ye, y2=se0, aff=torch.stack([aff1, ident]),
                  rT=bn._res_term(ye, ident, sop.res, sop))
    return (x0, x1), kw, x2, op.step_kw(), (ev, kwe)


def random_typed_inputs(torch, gen, R, Bl, W, D, F, acts, rate, alpha, res, absent, dev):
    """Ragged K16/K17 operands: sparse 'average' adjacencies, node types over
    range(T) without `absent`, per-type affines, weights and coefficient
    rows that keep every output O(1)."""
    T = len(acts)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)
    adj = random_adj(torch, gen, R, W, dev)
    kinds = torch.tensor([t for t in range(T) if t != absent])
    types = kinds[torch.randint(0, len(kinds), (R, W), generator=gen)].to(torch.int32).to(dev)
    aff = torch.stack([torch.stack([torch.rand(T, D, generator=gen) + 0.5,
                                    0.1 * torch.randn(T, D, generator=gen)]) for _ in range(2)])
    keep = ((torch.rand(R, W, 2 * D + F, generator=gen) > rate).to(torch.uint8).to(dev)
            if rate else None)
    nm = (torch.rand(R, W, generator=gen) < 0.8).float().to(dev)
    C = 2 * D + F + 1
    fwd = dict(adj_loop=adj[:Bl].contiguous(), adj_dep=adj[Bl:].contiguous() if Bl < R else None,
               y1=r(R, W, D), y2=r(R, W, D), aff=aff.to(dev), types=types, keep=keep,
               rT=r(R, W, D, scale=0.3) if res else None, feats=r(R, W, F, scale=0.5),
               w_stk=r(T * D, C, scale=0.5 / D ** 0.5), nm=nm)
    bwd = dict(adj_loop=fwd["adj_loop"], adj_dep=fwd["adj_dep"], y_prev=fwd["y1"], y_k=r(R, W, D),
               agg=r(R, W, D), types=types, keep=keep, feats=fwd["feats"], w_stk=fwd["w_stk"],
               ds_in=r(R, W, D, scale=0.1), gsel=r(R, W, D, scale=0.1),
               bnv=(0.5 + torch.rand(T, 9, D, generator=gen)).to(dev),
               flag=torch.tensor(1.0, device=dev), nm=nm)
    kw = dict(activations=tuple(acts), alpha_drop=alpha, rate=rate)
    return fwd, dict(bwd, **kw), kw


def check_typed_forward(torch, x, kw, label):
    from gnn_tpu_torch.ops import typed
    R, W, D = x["y1"].shape
    T = x["aff"].shape[2]
    return check_plain(torch, f"K16 {label}: R={R} (Bl={loop_rows(x)}) W={W} D={D} "
                       f"F={x['feats'].shape[-1]} T={T} {'/'.join(kw['activations'])} "
                       f"rate={kw['rate']} res={x['rT'] is not None} plan "
                       f"{typed._bnT_fwd_plan(W, D, x['feats'].shape[-1], T)[1]}",
                       *against_plain(torch, typed, "bnT_forward_step", dict(x, **kw)),
                       ("y", "agg", "flags", "msum"), summed=("msum",), exact=("flags",))


def typed_bounds(x_f, x_b):
    """(K16, K17) least times and what sets them: each input read once
    (types 4 bytes a node, keep bits a byte), each output written once;
    operations on the arcs present, each node's own type's dense layer and
    the elementwise work, as K1/K2."""
    adjs = [a for a in (x_f["adj_loop"], x_f["adj_dep"]) if a is not None]
    nnz = sum(_nnz(a) for a in adjs)
    R, W, D = x_f["y1"].shape
    F = x_f["feats"].shape[-1]
    T = x_f["aff"].shape[2]
    C = 2 * D + F + 1
    n = R * W
    f4 = 4
    keep_b = 0 if x_f["keep"] is None else n * (C - 1)
    adj_b = f4 * sum(a.numel() for a in adjs)
    shared = adj_b + keep_b + f4 * (n + n * F + T * D * C + n)   # adjacency, keep, types, feats, w, nm
    rt_b = 0 if x_f["rT"] is None else f4 * n * D
    bytes16 = shared + f4 * (2 * n * D + 4 * T * D) + rt_b + f4 * (2 * n * D + n + R * T * D)
    flops16 = 2 * D * nnz + 2 * D * C * n + 12 * D * n
    bytes17 = (shared + f4 * (5 * n * D + 9 * T * D + 1)
               + f4 * (2 * n * D + R * T * D * C + 2 * R * T * D))
    flops17 = 2 * D * nnz + 2 * D * C * n * 2 + 4 * D * D * n + 14 * D * n
    return bound(bytes16, flops16), bound(bytes17, flops17)


def phase_typed_kernels(torch, model, gb, gb_serve):
    """K16/K17 against their plain versions at the composite paths' full-set
    shapes (training: iterations 1 and 2 and the reverse of 2; serving: the
    second iteration) and at ragged shapes (W 32/64/96/128, D 5/14/64, F
    3/20, T 1/2/3/8, mixed activations, with and without keep-masks and
    residual rows, an absent type, weights in shared memory or read through
    the caches); K17 through check_bwd2; K16 at the edges of its design. The
    plans and occupancy of both and each of their plans timed; times and
    bounds at the training step's shapes."""
    from gnn_tpu_torch.ops import typed
    (x0, x1), kw, x2, kwb, (ev, kwe) = typed_kernel_inputs(torch, model, gb, gb_serve)
    check_typed_forward(torch, x0, kw, "full set, iteration 1")
    err16 = check_typed_forward(torch, x1, kw, "full set, iteration 2")
    check_typed_forward(torch, ev, kwe, "serving full set, iteration 2")
    R, W, D = x2["y_prev"].shape
    err17 = check_bwd2(torch, "K17", dict(x2, **kwb),
                       f"full set, reverse of iteration 2 (R={R} W={W} D={D} T={model.spec.n_types})")
    gen = torch.Generator().manual_seed(SEED + 24)
    reached = {0}     # K17's plan at the full set; the cases below take the others
    reached16 = {0}   # K16's plan at the full set
    for R, Bl, W, D, F, acts, alpha, rate, res, absent, dense in (
            (6, 4, 32, 5, 3, ("selu", "tanh", "relu"), True, 0.1, True, None, False),
            (5, 5, 96, 14, 3, ("selu",) * 8, True, 0.1, True, 3, False),
            (4, 2, 128, 64, 3, ("tanh", "linear"), False, 0.2, True, None, False),
            (3, 1, 64, 64, 20, ("relu", "selu", "tanh"), True, 0.0, False, None, False),
            (4, 3, 32, 14, 20, ("selu",), True, 0.1, True, None, False),
            (3, 3, 128, 14, 3, ("selu", "selu"), True, 0.1, False, 1, False),
            (3, 2, 32, 64, 20, ("selu", "relu") * 4, True, 0.1, True, 5, False),
            (3, 0, 128, 14, 3, ("selu",) * 4, True, 0.1, True, None, False),
            (2, 0, 32, 1, 0, ("tanh", "selu"), False, 0.1, True, None, True),
            (2, 1, 64, 14, 3, ("selu",) * 32, True, 0.1, True, None, False)):
        f, b, k = random_typed_inputs(torch, gen, R, Bl, W, D, F, acts, rate, alpha, res, absent,
                                      gb.device)
        if Bl == 0:     # the all-dep layout: no loop rows (adj_loop None)
            f, b = (dict(z, adj_loop=None) for z in (f, b))
        if dense:       # every row's entries read from device memory
            b["adj_dep"] = torch.full_like(b["adj_dep"], 1.0 / W)
        check_typed_forward(torch, f, dict(k, threshold=0.05), "ragged")
        T = len(acts)
        reached16.add(tiled_plan("K16", W, D, F, T)["plan"])
        check_bwd2(torch, "K17", b, f"ragged (R={R} Bl={Bl} W={W} D={D} F={F} T={T} "
                   f"{'/'.join(acts)} rate={rate} absent={absent}"
                   f"{' dense adjacency' if dense else ''}, plan "
                   f"{typed._bnT_bwd_plan(W, D, F, T)[1]})")
        check_repeat(torch, "K17", typed.bnT_backward_step, b, "ragged")
        reached.add(tiled_plan("K17", W, D, F, T)["plan"])
    if reached != set(range(len(plans_of("K17")))):
        fail(f"K17: the cases reach plans {sorted(reached)} of its {len(plans_of('K17'))}")
    # K16 at the edges of its design: against its plain version, a repeat
    # launch and every plan forced bit-identical, the plan the library takes
    # held to the mirror's, the cases reaching every plan
    for R, Bl, W, D, F, acts, rate, res, edge in (
            (3, 1, 32, 1, 3, ("tanh", "selu"), 0.1, True, "W 32, D 1"),
            (3, 2, 128, 64, 3, ("selu", "tanh"), 0.1, True, "D 64"),
            (3, 2, 128, 14, 3, ("selu",) * 4, 0.1, True, "a dense block"),
            (3, 2, 128, 14, 3, ("selu", "relu", "tanh"), 0.1, True, "a destination of 40 arcs"),
            (3, 2, 128, 14, 3, ("selu",), 0.1, True, "T 1"),
            (3, 2, 128, 14, 3, ("selu", "tanh", "relu", "linear") * 2, 0.1, True,
             "T 8, mixed activations"),
            (3, 2, 128, 14, 3, ("selu",) * 4, 0.0, False, "no dropout, no rT"),
            (3, 2, 128, 64, 3, ("selu",) * 8, 0.1, True, "weights read through the caches"),
            (2, 1, 128, 64, 120, ("selu", "relu") * 16, 0.1, True,
             "a shape only the leanest plan fits")):
        f, _, k = random_typed_inputs(torch, gen, R, Bl, W, D, F, acts, rate, True, res, None,
                                      gb.device)
        if edge == "a dense block":
            f = dict(f, adj_loop=random_adj(torch, gen, Bl, W, gb.device, dense=True),
                     adj_dep=random_adj(torch, gen, R - Bl, W, gb.device, dense=True))
        if edge == "a destination of 40 arcs":   # its column read from device memory
            for a in (f["adj_loop"], f["adj_dep"]):
                a[:, :40, 5] = 0.05
        kf = dict(k, threshold=0.05)
        check_typed_forward(torch, f, kf, f"tiling edge ({edge})")
        check_plans(torch, "K16", typed.bnT_forward_step, dict(f, **kf), (W, D, F, len(acts)),
                    edge)
        reached16.add(tiled_plan("K16", W, D, F, len(acts))["plan"])
    if reached16 != set(range(len(plans_of("K16")))):
        fail(f"K16: the cases reach plans {sorted(reached16)} of its {len(plans_of('K16'))}")
    R, W, D = x1["y1"].shape
    T, Fd = model.spec.n_types, x1["feats"].shape[-1]
    x2k = dict(x2, **kwb)
    dims = (W, D, Fd, T)
    plans_ms = time_plans(torch, "K17", typed.bnT_backward_step, x2k, dims,
                          check_tiled(torch, "K17", typed.bnT_backward_step, x2k, dims))
    # K16's plan and occupancy and each of its plans that fits, forced and
    # timed, at the training step's shapes; every plan forced at the serving
    # path's
    x1k = dict(x1, **kw)
    plans16 = time_plans(torch, "K16", typed.bnT_forward_step, x1k, dims,
                         check_tiled(torch, "K16", typed.bnT_forward_step, x1k, dims))
    check_plans(torch, "K16", typed.bnT_forward_step, dict(ev, **kwe), dims,
                f"serving full set ({ev['y1'].shape[0]} rows)")
    (b16, by16), (b17, by17) = typed_bounds(x1, x2)
    out = {
        "K16": dict(name="K16 bnT_forward_step", route="cuda",
                    source="gnn_tpu_torch/ops/csrc/bn_typed.cu",
                    replaces="gnn_tpu/ops/pallas_typed.py:84", max_abs_err=err16,
                    ms=timed_ms(torch, lambda: typed.bnT_forward_step(**x1, **kw)),
                    plain_ms=timed_ms(torch, lambda: typed.bnT_forward_step_ref(**x1, **kw)),
                    bound_ms=b16, bound_by=by16, library_ms=None),
        "K17": dict(name="K17 bnT_backward_step", route="cuda",
                    source="gnn_tpu_torch/ops/csrc/bn_typed.cu",
                    replaces="gnn_tpu/ops/pallas_typed.py:200", max_abs_err=err17,
                    ms=timed_ms(torch, lambda: typed.bnT_backward_step(**x2, **kwb)),
                    plain_ms=timed_ms(torch, lambda: typed.bnT_backward_step_ref(**x2, **kwb)),
                    bound_ms=b17, bound_by=by17, library_ms=None),
    }
    ev_ms = timed_ms(torch, lambda: typed.bnT_forward_step(**ev, **kwe))
    for k, v in out.items():
        say(f"{k} timing at {R} block rows, T={T}: kernel {v['ms']:.4f} ms, plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
            + (f"; each plan forced: {plans_ms}" if k == "K17" else "")
            + (f"; device time a call {device_ms(torch, lambda: typed.bnT_forward_step(**x1k), 1):.4f}"
               f" ms; each plan forced: {plans16}; at the serving path's "
               f"{ev['y1'].shape[0]} rows {ev_ms:.4f} ms" if k == "K16" else ""))
    return out


def phase_one_type(torch, gb, gb_train):
    """A composite model with one node type and the flagship's weights
    against the flagship on the same batches: its K16 forward against K3/K4
    (outputs within 1e-5, iterations equal), one K16/K17 training step
    against K1/K2 (iterations equal, loss rtol 1e-5, moving statistics
    1e-5, grads within rtol 2e-4 with a floor of 2e-5 of each tensor's
    largest entry)."""
    import dataclasses
    from gnn_tpu_torch import CompositeGNNgraphBased
    from gnn_tpu_torch.convert import flatten, params_to_jax
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused, typed
    say(f"---- one node type against the flagship ({elapsed()})")
    homo = flagship(torch, "cuda", "bn")
    comp = CompositeGNNgraphBased((homo.spec.state_spec,), homo.spec.output_spec, max_iteration=5,
                                  threshold=0.01, seed=SEED, device="cuda")
    p_np, b_np = params_to_jax(homo.params, homo.bn)
    comp.set_params({**p_np, "state": (p_np["state"],)}, {**b_np, "state": (b_np["state"],)})

    def typed0(b):
        return dataclasses.replace(b, node_types=torch.zeros(b.n_node_pad, dtype=torch.long,
                                                             device=b.device))
    for mod in (bn, fused, typed):
        mod.reset_launches()
    rc, rh = comp.forward(typed0(gb)), homo.forward(gb)
    torch.cuda.synchronize()
    launched = {k: v for k, v in {**bn.launches, **fused.launches, **typed.launches}.items() if v}
    if launched != {"bnT_forward_step": 5, "propagation_loop": 1, "propagation_step": 5}:
        fail(f"one-type forward launches {launched}")
    err = float((rc["out"] - rh["out"]).abs().max())
    if float(rc["iters"]) != float(rh["iters"]) or err > TOL:
        fail(f"one-type forward: iters {float(rc['iters'])} vs {float(rh['iters'])}, outputs "
             f"differ by {err:.3e}")
    masks = core.draw_masks(homo.spec, gb_train, torch.Generator(device="cuda").manual_seed(SEED))
    out_c = comp.training_step(typed0(gb_train), masks={"state": (masks["state"],),
                                                         "output": masks["output"]})
    out_h = homo.training_step(gb_train, masks=masks)
    if float(out_c["iters"]) != float(out_h["iters"]):
        fail(f"one-type step: iters {float(out_c['iters'])} vs {float(out_h['iters'])}")
    lerr = close_rel(torch, out_c["loss"].cpu(), out_h["loss"].cpu(), 1e-5, 0.0, "one-type loss")
    berr = max(float((comp.bn["state"][0][k] - homo.bn["state"][k]).abs().max())
               for k in ("mean", "var"))
    if berr > TOL:
        fail(f"one-type step: moving statistics differ by {berr:.3e}")
    grads_h = flatten({"state": homo.params["state"], "output": homo.params["output"]})
    grads_c = flatten({"state": comp.params["state"][0], "output": comp.params["output"]})
    gerr = 0.0
    for key, p in grads_c.items():
        ok, e = grads_close(p.grad.cpu(), grads_h[key].grad.cpu())
        gerr = max(gerr, e)
        if not ok:
            fail(f"one-type step: grad {key} differs from the K1/K2 route's by {e:.3e}")
    say(f"one type: K16 forward vs K3/K4 outputs {err:.3e}, iters {float(rc['iters'])}; "
        f"K16/K17 step vs K1/K2: loss {lerr:.3e}, moving stats {berr:.3e}, grads {gerr:.3e}")


def phase_serving(torch, label, model, model_cpu, gb, requests, expect, n_arcs,
                  per_request=None, predictor_kw=None, hold=None):
    """A serving path: Predictor(**predictor_kw) warmup + requests on the card,
    counting kernel launches (the wrappers `expect` must launch, no other;
    with `per_request`, exactly those counts each request), each response
    against the same model on the CPU (within TOL, or by `hold(label,
    request, card outputs, CPU outputs, CPU predictor)` -> largest
    difference); then the full-set forward's time and profile. Returns the
    launch counts."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    say(f"---- serving path '{label}' ({elapsed()})")
    pred = Predictor(model, **(predictor_kw or {}))
    pred_cpu = Predictor(model_cpu, device="cpu", **(predictor_kw or {}))

    def counts():
        return {**fused.launches, **fused2.launches, **bn.launches, **typed.launches,
                **segment.launches}
    for mod in (bn, fused, fused2, typed, segment):
        mod.reset_launches()
    t0 = time.perf_counter()
    warmed = pred.warmup([r for _, r in requests])
    say(f"warmup: {warmed} buckets in {time.perf_counter() - t0:.2f} s")
    served = []
    for name, req in requests:
        before = counts()
        t0 = time.perf_counter()
        out = pred.predict(req)
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: n - before[k] for k, n in counts().items() if n - before[k]}
        served.append((name, req, out, pred.stats["last_iters"]))
        n = 1 if not isinstance(req, list) else len(req)
        say(f"request {name!r}: {n} graphs, {ms:.3f} ms (predict), last_ms "
            f"{pred.stats['last_ms']}, iters {pred.stats['last_iters']}, launches {launched}")
        if per_request is not None and launched != per_request:
            fail(f"'{label}' request {name!r}: launches {launched}, expected {per_request}")
    launches = counts()
    say(f"serving path '{label}' launches: {launches}")
    for key, n in launches.items():
        if (key in expect) != (n > 0):
            fail(f"'{label}' serving path: {key} launched {n} times, expected "
                 f"{'some' if key in expect else 'none'}")

    # ---- served outputs against the same model on the CPU
    worst = 0.0
    for name, req, out, iters in served:
        ref = pred_cpu.predict(req)
        outs, refs = ([out], [ref]) if not isinstance(req, list) else (out, ref)
        if len(outs) != len(refs):
            fail(f"request {name!r}: {len(outs)} outputs, CPU gave {len(refs)}")
        if hold is not None:
            worst = max(worst, hold(f"'{label}' request {name!r}", req, outs, refs, pred_cpu))
        for o, r in zip(outs, refs):
            if hold is not None:
                continue
            if o.shape != r.shape or not (abs(o - r) <= TOL).all() or not (o == o).all():
                fail(f"'{label}' request {name!r}: output differs from the CPU run")
            worst = max(worst, float(abs(o - r).max()))
        if iters != pred_cpu.stats["last_iters"]:
            fail(f"'{label}' request {name!r}: iters {iters} on the card, "
                 f"{pred_cpu.stats['last_iters']} on the CPU")
    say(f"'{label}' served outputs vs CPU: max abs diff {worst:.3e} over {len(served)} requests")

    forward_time(torch, label, model, gb, n_arcs)
    return launches


def forward_time(torch, label, model, gb, n_arcs):
    """The full-set forward's host-clock time (median of 10, synchronized),
    propagation throughput and profile."""
    def fwd():
        r = model.forward(gb)
        torch.cuda.synchronize()
        return r
    iters = float(fwd()["iters"])
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fwd()
        times.append(time.perf_counter() - t0)
    times.sort()
    t_med = times[len(times) // 2]
    say(f"'{label}' full-set forward: {t_med * 1e3:.3f} ms median of 10 (host clock, "
        f"synchronized), iters {iters}, {n_arcs * iters / t_med:.4e} edges/s")
    phase_profile(torch, fwd, what=f"'{label}' full-set forward")


def phase_flat_layout(torch, graphs, typed, requests, n_arcs, dep_ms):
    """Blocked batches without the loop/dep layout (from_graphs_blocked(...,
    fused_layout=False): the all-dep layout, every block a dep block) under
    aggregation='fused', as gnn_tpu's per-step fused path: the flagship served
    through K4 every iteration and h150 through K9 (Predictor(fused_layout=
    False), K launches a request, no other kernel, outputs against the CPU);
    one BatchNorm step (K1/K2 over every block row) and one dropout step (K6
    per step over every block row) on the whole set, and one composite_bn
    step (K16/K17), each counted and held to the CPU as phase 12 holds its
    paths; K4, K9 and K6 against their plain versions and timed at these
    all-dep shapes beside their dep-row times `dep_ms` (phases 3, 6, 7)."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.batch import from_graphs_blocked
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused, fused2
    say(f"---- flat layout: 'fused' specs without loop blocks ({elapsed()})")
    model = flagship(torch, "cuda", "flat_bn")
    t0 = time.perf_counter()
    gb = Predictor(model, fused_layout=False).build_batch(graphs).to("cuda")
    gb_train = from_graphs_blocked(graphs, block_w=128, focus="g").to("cuda")
    gb_typed = from_graphs_blocked(typed, block_w=128, focus="g").to("cuda")
    say(f"all-dep batches: serving {gb.adj_dep.shape[0]} blocks, training "
        f"{gb_train.adj_dep.shape[0]}, composite training {gb_typed.adj_dep.shape[0]} "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    for b in (gb, gb_train, gb_typed):
        if b.adj_loop is not None or b.adj_dep.shape[0] != b.n_node_pad // b.block_w:
            fail("a batch without the loop/dep layout does not hold every block as a dep block")
    K = model.spec.max_iteration
    for label, variant, key in (("flat flagship", "flat_bn", "propagation_step"),
                                ("flat h150", "flat_h150", "propagation_step2")):
        phase_serving(torch, label, flagship(torch, "cuda", variant),
                      flagship(torch, "cpu", variant), gb, requests, (key,), n_arcs,
                      per_request={key: K}, predictor_kw={"fused_layout": False})
    for variant, b in (("flat_bn", gb_train), ("flat_dropout", gb_train),
                       ("composite_bn", gb_typed)):
        phase_training(torch, b, n_arcs, variant, 1)
    # the per-step kernels at the all-dep shapes
    h150 = flagship(torch, "cuda", "flat_h150")
    k6 = dep_step_operands(torch, flagship(torch, "cuda", "flat_dropout"), gb_train, SEED + 31)
    with torch.no_grad():
        _, k4 = kernel_inputs(model, gb)
        k4 = dict(k4, activation=model.spec.state_spec.activations[0])
        _, dep = core.hybrid2_operands(h150.spec, h150.params["state"], h150.bn["state"], gb)
        k9 = dict(dep, rT=core.residual_agg(gb, dep["s"]),
                  **dict(zip(("act0", "act1"), h150.spec.state_spec.activations)))
        for k, mod, name, x in (("K4", fused, "propagation_step", k4),
                                ("K9", fused2, "propagation_step2", k9),
                                ("K6", fused, "train_step", k6)):
            got, want = against_plain(torch, mod, name, x)
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            names = ("y", "agg") if k == "K6" else ("out",)
            err = check_plain(torch, f"{k} all-dep {tuple(x['adjT'].shape)}", got, want, names)
            ms = timed_ms(torch, lambda: getattr(mod, name)(**x))
            plain = timed_ms(torch, lambda: getattr(mod, name + "_ref")(**x))
            plans = ""
            if k == "K9":
                dims = (x["adjT"].shape[1], x["w1"].shape[0], x["feats"].shape[-1],
                        x["w0"].shape[0])
                plans = (f"; device time a call {device_ms(torch, lambda: step2_out(**x), 1):.4f} ms"
                         f"; each plan forced: {time_plans(torch, k, step2_out, x, dims, (got[0],))}")
            if k == "K4":
                dims = (x["adjT"].shape[1], x["s"].shape[-1], x["w2"].shape[0] // 2, 0)
                check_tiled(torch, k, step_out, x, dims)
                plans = f"; device time a call {device_ms(torch, lambda: step_out(**x), 1):.4f} ms"
            if k == "K6":
                dims = (x["adjT"].shape[1], x["s"].shape[-1], x["fT"].shape[-1], 0)
                check_tiled(torch, k, fused.train_step, x, dims)
                plans = (f"; device time a call: kernel "
                         f"{device_ms(torch, lambda: fused.train_step(**x), 1):.4f} ms, plain "
                         f"{device_ms(torch, lambda: fused.train_step_ref(**x)):.4f} ms")
            say(f"{k} at the all-dep shape adjT {tuple(x['adjT'].shape)}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, max per-node difference {err:.3e}; at the dep rows "
                f"{dep_ms[k]:.4f} ms{plans}")


def close_rel(torch, got, want, rtol, floor, label):
    err = (got - want).abs()
    if not bool((err <= rtol * want.abs() + floor * want.abs().max()).all()):
        fail(f"{label}: card and CPU differ by {float(err.max()):.3e}")
    return float(err.max())


def grads_close(got, want, rtol=2e-4, floor=2e-5):
    """(within rtol of each entry with a floor of `floor` times the largest
    entry, the largest difference)."""
    err = (got - want).abs()
    return bool((err <= rtol * want.abs() + floor * want.abs().max()).all()), float(err.max())


def first_step_grads64(torch, variant, gb_cpu, masks):
    """The first training step's grads of `variant` on the CPU in float64, on
    the same weights and masks."""
    return steps64(torch, variant, gb_cpu, [masks])[1]


def steps64(torch, variant, gb_cpu, masks, optimizer="adam"):
    """The model of `variant` after one training step for each mask set in
    `masks` on the CPU in float64, from the same weights (the params after the
    optimizer's last step), and its first step's grads by key."""
    from gnn_tpu_torch.convert import flatten
    model = to_float64(torch, flagship(torch, "cpu", variant, optimizer))
    gb64 = batch64(torch, gb_cpu)
    grads = None
    for m in masks:
        m = tree_map(lambda v: v.double() if v.is_floating_point() else v, m)   # the initial state
        model.training_step(gb64, masks=m)
        if grads is None:
            grads = {key: p.grad.clone() for key, p in flatten(model.params).items()}
    return model, grads


def to_float64(torch, model):
    """`model` (a GNN or an LGNN) with its params, moving statistics and
    optimizer in float64, in place."""
    from gnn_tpu_torch.models import core
    for p in core.param_leaves(model._params() if hasattr(model, "gnns") else model.params):
        p.data = p.data.double()
    for m in getattr(model, "gnns", [model]):
        m.bn = tree_map(lambda v: v.double(), m.bn)
    return model


def batch64(torch, gb):
    """The batch with its float32 tensors in float64."""
    import dataclasses
    return dataclasses.replace(gb, **{
        f.name: getattr(gb, f.name).double() for f in dataclasses.fields(gb)
        if torch.is_tensor(getattr(gb, f.name))
        and getattr(gb, f.name).dtype == torch.float32})


def hold_grads(torch, label, card, cpu, twin, feeds=None, switched=None, witness=None):
    """The first step's grads on the card (`card`, by key) against the CPU's
    (`cpu`): within rtol 2e-4 with a floor of 2e-5 of each tensor's largest
    entry. A tensor that misses it is held to the float64 twin of the CPU's
    step on the same weights and masks (`twin()` -> float64 grads by key,
    asked for on the first miss), the exact value both float32 steps
    approximate: it passes if the card meets the same elementwise bound
    against it (the CPU's float32 step is then the one off), or against
    `switched()` where given: the float64 step with the derivative branch
    switched at the kinked units where the card's own recorded pre-activation
    lies on the other side of the kink (the branch the card took; None if
    there is none). Otherwise it is accepted only if a float32 computation
    without the kernels misses that bound against float64 too, in this tensor
    or in one whose reverse feeds it (`feeds(key)` -> keys; by default the
    tensor alone): the CPU's step, or where given `witness` ((its name, a
    function -> grads by key) of another such step, asked for only then). The gradient is then
    set-valued at this scale (pre-activations of a kinked activation within
    rounding of 0 take either derivative branch, gnn_tpu's adjudication,
    docs/kernels.md:241-249) and no float32 computation meets an elementwise
    bound; the card is held norm-wise to the float64 step: ||card - g64|| <=
    2e-4 ||g64||. Returns the largest elementwise card-vs-CPU difference."""
    import functools
    worst, missed = 0.0, []
    for key, want in cpu.items():
        got = card[key].cpu()
        if not bool(torch.isfinite(got).all()):
            fail(f"{label} grad {key}: non-finite on the card")
        ok, err = grads_close(got, want)
        worst = max(worst, err)
        if not ok:
            missed.append((key, err))
    if not missed:
        return worst
    g64 = twin()

    def off(grads):
        return {k: g for k, g in g64.items() if not grads_close(grads[k].double(), g)[0]}
    cpu_off = off(cpu)
    wit_off = functools.cache(lambda: off(witness[1]()))
    for key, err in missed:
        g = g64[key]
        got, want = card[key].cpu().double(), cpu[key].double()
        card_ok64, card_err64 = grads_close(got, g)
        err64 = grads_close(want, g)[1]
        if card_ok64:
            say(f"{label} grad {key}: card vs CPU {err:.3e} misses the elementwise bound; the "
                f"card is within it of the float64 step ({card_err64:.3e}), the CPU's float32 "
                f"{err64:.3e} from it")
            continue
        sw = switched() if switched is not None else None
        if sw is not None:
            sw_ok, sw_err = grads_close(got, sw["grads"][key])
            if sw_ok:
                say(f"{label} grad {key}: card vs CPU {err:.3e} and vs float64 {card_err64:.3e} "
                    f"miss the elementwise bound; the card is within it ({sw_err:.3e}) of the "
                    f"float64 step along its own derivative branches ({sw['units']})")
                continue
        fed_by = feeds(key) if feeds is not None else (key,)
        fed, by = [k for k in fed_by if k in cpu_off], "the CPU's float32"
        if not fed and witness is not None:
            fed, by = [k for k in fed_by if k in wit_off()], witness[0]
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        r_card = float(torch.linalg.norm(got - g) / torch.linalg.norm(g))
        r_cpu = float(torch.linalg.norm(want - g) / torch.linalg.norm(g))
        if not fed:
            fail(f"{label} grad {key}: card and CPU differ by {err:.3e} (norm-wise {rel:.3e}), "
                 f"card and float64 by {card_err64:.3e} (norm-wise {r_card:.3e}); neither the "
                 f"CPU's float32{f' nor {witness[0]}' if witness else ''} misses the bound "
                 f"against float64 in a tensor feeding this one (the CPU's here {err64:.3e})")
        if r_card > 2e-4:
            fail(f"{label} grad {key}: card and CPU differ by {err:.3e} (norm-wise {rel:.3e}); "
                 f"{by} misses the bound against float64 in {fed[0]}, but norm-wise the card is "
                 f"{r_card:.3e} from float64 (bound 2e-4; the CPU {r_cpu:.3e})")
        say(f"{label} grad {key}: card vs CPU {err:.3e} misses the elementwise bound, as "
            f"{by} misses it against float64 in {fed[0]}"
            f"{f' and {len(fed) - 1} more tensors feeding this one' if len(fed) > 1 else ''}; "
            f"norm-wise card vs CPU {rel:.3e}, from float64 card {r_card:.3e}, CPU {r_cpu:.3e}")
    return worst


def hold_params(torch, label, card, cpu, grads0, twin, steps, replay=None):
    """The params after `steps` steps on the card (`card`, by key) against
    the CPU's (`cpu`) where they differ by more than TOL, held to the float64
    steps from the same weights with the same masks (`twin()` -> (float64
    params, float64 first-step grads) by key), the exact values both float32
    runs approximate. Adam's step moves each entry by lr * m / (sqrt(v) +
    eps): an entry whose gradients are within rounding of 0, or set-valued
    (hold_grads), moves by a share of lr that rounding decides, so there both
    float32 runs may miss TOL against each other and against float64. A
    tensor passes if the card is within TOL of the float64 steps (the CPU's
    float32 is then the one off); else the card's first-step grads of that
    tensor (`grads0`) must be within the grads bound (rtol 2e-4, floor 2e-5
    of the largest entry) of the float64 grads, and it passes if the CPU's
    own float32 steps miss TOL against float64 too, or if after one step
    (`replay()` -> the optimizer's float64 update on the card's own
    first-step grads, by key, update64) the card is within TOL of that
    update: the grads and the optimizer are then each held to their bound,
    and what is left is the update's sensitivity to a gradient within
    rounding of 0, which the CPU's float32 step may happen to escape (on one
    H100 the width-128 BN step's first-layer weights landed 4.4e-6, 7.5e-6
    and 1.0e-5 from the CPU's in three runs of phase 18: the card's float32
    steps differ between runs). Else it fails. Returns the largest
    card-vs-CPU difference."""
    worst = 0.0
    for key, p in cpu.items():
        got = card[key].detach().cpu()
        err = float((got - p.detach()).abs().max())
        worst = max(worst, err)
        if err <= TOL:
            continue
        p64, g64 = twin()
        want = p64[key].detach().cpu()
        card64 = float((got.double() - want).abs().max())
        cpu64 = float((p.detach().double() - want).abs().max())
        grads_ok, gerr = grads_close(grads0[key].cpu().double(), g64[key].cpu())
        rep = (float((got.double() - replay()[key]).abs().max())
               if card64 > TOL and grads_ok and replay is not None and steps == 1 else None)
        if card64 <= TOL:
            verdict = "the card is within it of the float64 steps"
        elif cpu64 > TOL and grads_ok:
            verdict = ("the CPU's float32 misses it against float64 too, and the card's "
                       f"first-step grads are within their bound of the float64 grads ({gerr:.3e})")
        elif rep is not None and rep <= TOL:
            miss = (got.double() - want).abs() > TOL
            g = g64[key].cpu().double().abs()
            verdict = (f"the card is within it ({rep:.3e}) of the optimizer's float64 update on "
                       f"the card's own first-step grads, which are within their bound of the "
                       f"float64 grads ({gerr:.3e}); the {int(miss.sum())} entries that miss "
                       f"float64 have float64 grads of at most {float(g[miss].max()):.3e} (the "
                       f"tensor's largest {float(g.max()):.3e})")
        else:
            fail(f"{label} params {key} after {steps} steps: card vs CPU {err:.3e}, card vs "
                 f"float64 {card64:.3e}, CPU vs float64 {cpu64:.3e}, card's first-step grads vs "
                 f"float64 {gerr:.3e} ({'within' if grads_ok else 'outside'} their bound)"
                 f"{'' if rep is None else f', card vs the float64 update on its grads {rep:.3e}'}")
        say(f"{label} params {key} after {steps} steps: card vs CPU {err:.3e} misses {TOL:g}; "
            f"{verdict} (card vs float64 {card64:.3e}, CPU vs float64 {cpu64:.3e})")
    return worst


def check_params64(torch, variant, card, cpu, grads0, gb_cpu, masks, optimizer="adam"):
    """A model's params after the steps on the card (`card`) against the
    CPU's (`cpu`), held by hold_params to the float64 steps of `variant`
    (steps64) with the same masks (`masks`, one set a step), and after one
    step to the optimizer's float64 update on the card's grads (`grads0`)
    from the variant's weights."""
    import functools
    from gnn_tpu_torch.convert import flatten

    @functools.cache
    def twin():
        m64, g64 = steps64(torch, variant, gb_cpu, masks, optimizer)
        return flatten(m64.params), g64

    @functools.cache
    def replay():
        return update64(torch, flatten(flagship(torch, "cpu", variant, optimizer).params),
                        grads0, optimizer)
    return hold_params(torch, f"'{variant}'", flatten(card.params), flatten(cpu.params), grads0,
                       twin, len(masks), replay)


def update64(torch, before, grads, optimizer):
    """The params after one step of `optimizer` (a config or a name) in
    float64 from the params `before` on the grads `grads` (both by key)."""
    from gnn_tpu_torch.training.optimizers import make_optimizer
    leaves = {k: v.detach().cpu().double().clone().requires_grad_(True)
              for k, v in before.items()}
    for k, leaf in leaves.items():
        leaf.grad = grads[k].detach().cpu().double()
    make_optimizer(optimizer, list(leaves.values())).step()
    return {k: leaf.detach() for k, leaf in leaves.items()}


def check_first_grads(torch, variant, card, cpu, gb_cpu, masks):
    """The first step's grads on the card (`card`, by key) against the CPU
    model's (`cpu`), held by hold_grads, each tensor on its own, to the
    float64 step of `variant` on the same weights and masks."""
    from gnn_tpu_torch.convert import flatten
    return hold_grads(torch, f"'{variant}'", card,
                      {k: p.grad for k, p in flatten(cpu.params).items()},
                      lambda: first_step_grads64(torch, variant, gb_cpu, masks))


def phase_training(torch, gb, n_arcs, variant, steps, optimizer="adam", profile=True):
    """A training path on the card, counted (ROUTES[variant] launches, no
    other kernel), then the same steps on the CPU with the card's masks;
    step time and profile (with `profile`). Params that miss TOL against the
    CPU's after the steps are held to the float64 steps (check_params64).
    `optimizer`: the models' optimizer config or name. Returns the launch
    counts of the steps."""
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    model = flagship(torch, "cuda", variant, optimizer)
    cpu = flagship(torch, "cpu", variant, optimizer)
    gb_cpu = gb.to("cpu")
    K = model.spec.max_iteration
    say(f"---- training path '{variant}' ({elapsed()})")

    # ---- main path: training steps, counting kernel launches
    masks, log, grads0 = [], [], None
    times = []
    for mod in (bn, fused, fused2, typed, segment):
        mod.reset_launches()
    for i in range(steps):
        m = model._draw_masks(model.spec, gb, model.mask_gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.training_step(gb, masks=m)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        masks.append(m)
        log.append((out["iters"], out["loss"], flatten(tree_map(torch.clone, model.bn["state"]))))
        if i == 0:
            grads0 = {key: p.grad.clone() for key, p in flatten(model.params).items()}
    launches = {**bn.launches, **fused.launches, **fused2.launches, **typed.launches,
                **segment.launches}
    say(f"training path '{variant}' launches over {steps} steps: {launches}")
    for key, n in launches.items():
        per_step = ROUTES[variant_width(variant)[1]].get(key, 0)
        want = steps * {"K": K, "2K-1": 2 * K - 1}.get(per_step, per_step)
        if n != want:
            fail(f"'{variant}' path: {key} launched {n} times in {steps} steps, expected {want}")
    for p in core.param_leaves(model.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"'{variant}' path: non-finite parameters after training")
    med = sorted(times)[len(times) // 2]
    iters = float(log[-1][0])
    say(f"training step '{variant}': {med * 1e3:.3f} ms median of {steps} (host clock, "
        f"synchronized; each {[round(t * 1e3, 3) for t in times]} ms), iters "
        f"{[float(r[0]) for r in log]}, losses {[round(float(r[1]), 4) for r in log]}, "
        f"{n_arcs * iters / med:.4e} edges/s")

    # ---- the same steps on the CPU with the card's masks
    t0 = time.perf_counter()
    worst = {"loss": 0.0, "bn": 0.0, "grad": 0.0}
    for i in range(steps):
        m = tree_map(lambda v: v.cpu(), masks[i])
        out = cpu.training_step(gb_cpu, masks=m)
        it, loss, stats = log[i]
        if float(out["iters"]) != float(it):
            fail(f"'{variant}' step {i}: iters {float(it)} on the card, "
                 f"{float(out['iters'])} on the CPU")
        worst["loss"] = max(worst["loss"], close_rel(torch, loss.cpu(), out["loss"], 1e-5, 0.0,
                                                     f"'{variant}' step {i} loss"))
        cpu_stats = flatten(cpu.bn["state"])
        for k in stats:
            err = float((stats[k].cpu() - cpu_stats[k]).abs().max())
            worst["bn"] = max(worst["bn"], err)
            if err > TOL:
                fail(f"'{variant}' step {i}: moving {k} differs from the CPU by {err:.3e}")
        if i == 0:
            worst["grad"] = check_first_grads(torch, variant, grads0, cpu, gb_cpu, m)
    perr = check_params64(torch, variant, model, cpu, grads0, gb_cpu,
                          [tree_map(lambda v: v.cpu(), m) for m in masks], optimizer)
    say(f"'{variant}' training vs CPU over {steps} steps ({time.perf_counter() - t0:.1f} s): "
        f"iters equal, max loss diff {worst['loss']:.3e}, moving stats {worst['bn']:.3e}, "
        f"first-step grads {worst['grad']:.3e}, params after the last step {perr:.3e}")

    def step():
        model.training_step(gb)
        torch.cuda.synchronize()
    if profile:
        phase_profile(torch, step, runs=3, what=f"'{variant}' training step")
    return launches

WIDE_D = (65, 80, 128, 200, 201)   # state widths of phase 18's kernel cases (201: odd)


def wide_graphs(width, seed=SEED, al=3):
    """Ten small graphs and one of 300 nodes (dep blocks at block width 128)
    with `width` node-label columns, `al` arc-label columns and 2 classes."""
    import numpy as np
    from gnn_tpu_torch.graphs.datasets import random_graph
    rng = np.random.default_rng(seed)
    graphs = [random_graph(int(rng.integers(8, 30)), width, al, 2, 0.5, focus="g", rng=rng)
              for _ in range(10)]
    graphs.append(random_graph(300, width, al, 2, 0.02, focus="g", rng=rng))
    return graphs


def relabelled(graphs, width, seed):
    """The graphs with their node labels replaced by a seeded
    [n_nodes, width] standard-normal array each (default_rng(seed), in
    order)."""
    import numpy as np
    from gnn_tpu_torch import Graph
    rng = np.random.default_rng(seed)
    return [Graph(g.arcs, rng.standard_normal((g.n_nodes, width)).astype(np.float32), g.targets,
                  focus=g.focus, set_mask=g.set_mask, output_mask=g.output_mask,
                  sample_weights=g.sample_weights, node_graph=g.NodeGraph,
                  aggregation_mode=g.aggregation_mode) for g in graphs]


def wide_kernel_cases(torch, gen, B, W, D, H, rate, alpha, act):
    """{kernel: [(wrapper outputs as a tuple, operands)]} of K1-K8 at one shape
    and dropout mode: K3 and K4 (with rT; K4 D wide, H wide), K5 with the
    affine, K6 (D wide, H wide) with rT, K7, K8, K1 with rT and K2."""
    from gnn_tpu_torch.ops import bn, fused
    dev = "cuda"
    x = random_inputs(torch, gen, B, W, D, H, dev, res=True)
    x3 = random_inputs(torch, gen, B, W, D, D, dev, res=False)
    nm = (torch.rand(B, W, generator=gen) < 0.8).float().to(dev)
    k5, k6, k7, k8 = random_bnfree_inputs(torch, gen, B, W, D, H, 3, rate, alpha, act, dev)
    f, b = random_bn_inputs(torch, gen, B + 1, B, W, D, 3, rate, True, dev)
    kw = dict(activation=act, alpha_drop=alpha, rate=rate)
    return {
        "K3": (lambda **a: fused.propagation_loop(**a),
               dict(adjT=x3["adjT"], s0=x3["s"], fT=x3["fT"], w2=x3["w2"], affine=x3["affine"],
                    nm=nm, K=3, threshold=0.05, activation=act)),
        "K4": (step_out, dict(x, activation=act)),
        "K5": (lambda **a: fused.propagation_loop_bwd(**a), k5),
        "K6": (lambda **a: fused.train_step(**a), k6),
        "K7": (lambda **a: fused.train_loop(**a), k7),
        "K8": (lambda **a: fused.train_loop_bwd(**a), k8),
        "K1": (lambda **a: bn.bn_forward_step(**a), dict(f, **kw, threshold=0.05)),
        "K2": (lambda **a: bn.bn_backward_step(**a), dict(b, **kw)),
    }


def wide_dims(k, x):
    """(W, D, AL or F or H, H1) of kernel k's operands, as its plan entries
    take them."""
    adj = next(x[a] for a in ("adjT", "adj_loop", "adj_dep") if x.get(a) is not None)
    W = adj.shape[1]
    if k in ("K1", "K2"):
        return W, x["y1" if k == "K1" else "y_prev"].shape[-1], x["feats"].shape[-1], 0
    if k in ("K4", "K6"):
        D = x["s"].shape[-1]
        return W, D, x["w2"].shape[0] // 2 if k == "K4" else x["w_cat"].shape[0], 0
    if k in ("K9", "K10", "K11", "K12", "K13"):
        return (W, x["s" if k == "K9" else "s0"].shape[-1],
                x["fd" if k in ("K12", "K13") else "feats"].shape[-1], x["w0"].shape[0])
    if k in ("K14", "K15"):
        return (W, x["y1" if k == "K14" else "y_prev"].shape[-1], x["feats"].shape[-1],
                x["w0_aug"].shape[0])
    if k in ("K16", "K17"):
        return (W, x["y1" if k == "K16" else "y_prev"].shape[-1], x["feats"].shape[-1],
                x["aff"].shape[2] if k == "K16" else x["bnv"].shape[0])
    return W, x["s0"].shape[-1], 0, 0


def check_wide_forced(torch, k, run, x, label):
    """Kernel k's wide plan forced at a shape a staged plan takes: every
    output bit for bit the staged plan's."""
    dims = wide_dims(k, x)
    info = tiled_plan(k, *dims)
    wide = len(plans_of(k))
    if info["plan"] == wide:
        fail(f"{k} {label}: the staged plans fit {dims}, but the library takes the wide plan")
    first = outputs_of(run(**x))
    force = force_entry(k)
    force(wide)
    try:
        if plan_info(k, *dims)["plan"] != wide:
            fail(f"{k} {label}: the wide plan could not be forced at {dims}")
        forced = outputs_of(run(**x))
    finally:
        force(-1)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, forced)):
        if a is not None and not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"{k} {label}: output {i} of the wide plan, forced, differs from staged plan "
                 f"{info['plan']}'s in {int((a != b).sum())} entries, by up to "
                 f"{float((a - b).abs().max()):.3e}")
    return info["plan"]


def outputs_of(r):
    return r if isinstance(r, tuple) else (r,)


def check_wide_kernel(torch, k, x, label):
    """Kernel k at a width above the staged plans' reach (or at W 32, where
    they may still fit) against its plain version; its plan held to the
    mirror's. Returns the plan."""
    from gnn_tpu_torch.ops import bn, fused
    info = tiled_plan(k, *wide_dims(k, x))
    if k == "K3":
        check_plain(torch, f"K3 {label}", *against_plain(torch, fused, "propagation_loop", x),
                    ("traj", "margins"), exact=("margins",))
    elif k == "K4":
        check_step(torch, fused, {a: v for a, v in x.items() if a != "activation"},
                   x["activation"], label)
    elif k == "K5":
        check_plain(torch, f"K5 {label}", *against_plain(torch, fused, "propagation_loop_bwd", x),
                    ("gs", "dw2", "dfT", "daff"), summed=("dw2", "daff"))
    elif k == "K6":
        check_plain(torch, f"K6 {label}", *against_plain(torch, fused, "train_step", x),
                    ("y", "agg"))
    elif k == "K7":
        check_plain(torch, f"K7 {label}", *against_plain(torch, fused, "train_loop", x),
                    ("traj", "margins", "agg"), exact=("margins",))
    elif k == "K8":
        check_bwd2(torch, "K8", x, label)
    elif k == "K1":
        check_plain(torch, f"K1 {label}", *against_plain(torch, bn, "bn_forward_step", x),
                    ("y", "agg", "flags", "msum"), summed=("msum",), exact=("flags",))
    else:
        check_bwd2(torch, "K2", x, label)
    return info["plan"]


def phase_wide(torch):
    """Phase 18: widths beyond the staged plans' reach on every kernel with
    plans: state widths above 64 on the one-layer kernels K1-K8, state,
    arc-label and hidden widths and node-type counts on the two-layer and
    typed kernels K9-K17 (each kernel's wide plan, chosen where no staged
    plan fits), the models that need them served and trained through their
    kernels, and width 128 at full scale."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.graphs.generator import GraphDataGenerator
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused, segment
    gen = torch.Generator().manual_seed(SEED + 60)
    say(f"---- state widths above 64 ({elapsed()})")

    # ---- 1. K1-K8 against their plain versions at D 65/80/128/200/201, W 128
    # and 32, in the three dropout modes; K4 and K6 also with D != H, K1, K4
    # and K6 without rT, K5 without the affine
    reached = {}
    for W in (128, 32):
        for D in WIDE_D:
            for rate, alpha in ((0.1, True), (0.1, False), (0.0, True)):
                H = D if rate or W == 32 else {65: 130, 80: 33, 128: 200, 200: 65, 201: 99}[D]
                cases = wide_kernel_cases(torch, gen, 2, W, D, H, rate, alpha, "selu")
                mode = f"W={W} D={D} H={H} rate={rate} alpha={alpha}"
                for k, (_, x) in cases.items():
                    if rate == 0.1 and not alpha and k in ("K3", "K4", "K5"):
                        continue   # no dropout in these; two modes suffice
                    reached.setdefault(k, set()).add(check_wide_kernel(torch, k, x, mode))
                    if k in ("K1", "K4", "K6") and rate == 0.0:
                        check_wide_kernel(torch, k, dict(x, rT=None), mode + ", rT=None")
                    if k == "K5" and rate == 0.0:
                        check_wide_kernel(torch, k, dict(x, affine=None), mode + ", no affine")
    # and at W 96 and 64, and D 1024 (one block each)
    for W, D, H in ((96, 301, 301), (64, 130, 70), (128, 1024, 1024), (32, 1024, 333)):
        for k, (_, x) in wide_kernel_cases(torch, gen, 1, W, D, H, 0.1, True, "selu").items():
            reached[k].add(check_wide_kernel(torch, k, x, f"W={W} D={D} H={H} rate=0.1"))
    for k in sorted(reached, key=lambda k: int(k[1:])):
        if len(plans_of(k)) not in reached[k]:
            fail(f"{k}: the wide cases never reached its wide plan (plans {sorted(reached[k])})")
    say(f"K1-K8 at D {WIDE_D}: every case within its bounds of the plain version; plans "
        f"reached {dict((k, sorted(v)) for k, v in reached.items())}")

    # ---- 2. each wide plan forced at D 14 and 64 against the staged plans,
    # bit for bit
    for W, D in ((128, 14), (128, 64), (32, 14), (32, 64)):
        for rate, alpha in ((0.1, True), (0.0, True)):
            for k, (run, x) in wide_kernel_cases(torch, gen, 2, W, D, D, rate, alpha,
                                                 "selu").items():
                label = f"W={W} D={D} rate={rate}"
                check_wide_forced(torch, k, run, x, label)
                if k in ("K4", "K6") and x.get("rT") is not None:
                    check_wide_forced(torch, k, run, dict(x, rT=None), label + ", rT=None")
        say(f"K1-K8 wide plans forced at W={W} D={D}: bit-identical to the staged plans")

    # ---- 2b. K9-K17 against their plain versions beyond the staged plans'
    # widths, and each wide plan forced where a staged plan fits
    wide_kernels_two_layer(torch, gen)

    # ---- 3. one-layer models of width 80 and 128 on fused-layout batches:
    # served and trained through K1-K8, counted, against the CPU
    for width in (80, 128):
        graphs = wide_graphs(width)
        n_arcs = sum(g.n_arcs for g in graphs)
        card = flagship(torch, "cuda", f"w{width}_bn")
        gb = card.to_batch(graphs)
        if gb.adj_loop is None or gb.adj_dep is None:
            fail(f"width {width}: the batch lacks loop or dep blocks")
        for variant, ev, tr in (("bn", "hybrid", "bn"), ("dropout", "hybrid", "dropout"),
                                ("clean", "hybrid", "hybrid")):
            m = flagship(torch, "cuda", f"w{width}_{variant}")
            routes = (core._eval_route(m.spec, gb), core._train_route(m.spec, gb))
            if routes != (ev, tr):
                fail(f"width {width} '{variant}': routes {routes}, expected {(ev, tr)}")
        requests = [("all", graphs), ("small", graphs[1]), ("big", graphs[-1]),
                    ("five", graphs[4:9])]
        phase_serving(torch, f"w{width}_bn", card, flagship(torch, "cpu", f"w{width}_bn"), gb,
                      requests, ("propagation_loop", "propagation_step"), n_arcs)
        for variant in ("bn", "dropout", "clean"):
            phase_training(torch, gb, n_arcs, f"w{width}_{variant}", 1)

    # ---- 4. the two-layer and composite models beyond the staged plans'
    # widths (state and arc-label width 80, hidden width 600, 33 node types)
    # served and trained through K9-K17, counted, against the CPU; through
    # 'pallas' (K18) on a plan batch a width-80 model runs too
    for variant, serve in WIDE_PATHS:
        dims = variant_dims(variant)
        graphs = wide_graphs(dims["width"], al=dims["al"])
        if dims["base"] == "composite_bn":
            graphs = typed_graphs(graphs, dims["types"])
        n_arcs = sum(g.n_arcs for g in graphs)
        card = flagship(torch, "cuda", variant)
        gb = card.to_batch(graphs)
        if serve:
            requests = [("all", graphs), ("small", graphs[1]), ("big", graphs[-1]),
                        ("five", graphs[4:9])]
            phase_serving(torch, variant, card, flagship(torch, "cpu", variant), gb, requests,
                          serve, n_arcs)
        phase_training(torch, gb, n_arcs, variant, 1, profile=False)
    graphs = wide_graphs(80)
    plan_cpu = next(iter(GraphDataGenerator(graphs, batch_size=len(graphs), shuffle=False,
                                            build_plan=True)))
    plan = plan_cpu.to("cuda")
    card, cpu = flagship(torch, "cuda", "w80_pallas"), flagship(torch, "cpu", "w80_pallas")
    K = card.spec.max_iteration
    segment.reset_launches()
    before = port_launches()
    res = card.forward(plan)
    torch.cuda.synchronize()
    n_fwd = segment.launches["segment_aggregate"]
    masks = card._draw_masks(card.spec, plan, card.mask_gen)
    out = card.training_step(plan, masks=masks)
    torch.cuda.synchronize()
    n_step = segment.launches["segment_aggregate"] - n_fwd
    if (n_fwd, n_step) != (K, 2 * K - 1) or port_launches() != before + n_fwd + n_step:
        fail(f"width 80 'pallas': K18 launched {n_fwd} times a forward and {n_step} a step "
             f"(expected {K} and {2 * K - 1}), {port_launches() - before} launches in all")
    ref = cpu.forward(plan_cpu)
    out_cpu = cpu.training_step(plan_cpu, masks=tree_map(lambda v: v.cpu(), masks))
    sel = plan_cpu.sel_mask
    err = float((res["out"].cpu()[sel] - ref["out"][sel]).abs().max())
    iters = [float(r["iters"]) for r in (res, ref, out, out_cpu)]
    if iters[0] != iters[1] or iters[2] != iters[3] or not err <= TOL:
        fail(f"width 80 'pallas': iterations {iters}, outputs differ by {err:.3e}")
    loss = close_rel(torch, out["loss"].cpu(), out_cpu["loss"], 1e-5, 0.0, "w80 'pallas' loss")
    say(f"width 80 'pallas' on the plan batch: K18 {n_fwd} launches a forward, {n_step} a step; "
        f"outputs within {err:.3e} of the CPU, loss within {loss:.3e}")

    # ---- 5. width 128 at full scale: the MUTAG-shaped set's graphs and arcs
    # with seeded 128-wide node labels; K1-K8 timed at the main paths'
    # shapes against their bounds, their workspace; the forward and each
    # one-layer route's step by device time
    t0 = time.perf_counter()
    graphs = relabelled(mutag_shaped(seed=SEED), 128, SEED + 61)
    model = flagship(torch, "cuda", "w128_bn")
    gb = Predictor(model).build_batch(graphs).to("cuda")
    gb_train = model.to_batch(graphs)
    say(f"width 128, MUTAG-shaped set: serving batch {gb.adj_loop.shape[0]} loop and "
        f"{gb.adj_dep.shape[0]} dep rows, training batch {gb_train.adj_loop.shape[0]} and "
        f"{gb_train.adj_dep.shape[0]} ({time.perf_counter() - t0:.1f} s)")
    with torch.no_grad():
        K, thr = model.spec.max_iteration, float(model.spec.threshold)
        act = model.spec.state_spec.activations[0]
        loop, step = kernel_inputs(model, gb)
        x3 = dict(loop, K=K, threshold=thr, activation=act)
        x4 = dict(step, activation=act)
        (b3, by3), (b4, by4) = serving_bounds(loop, step, K)
        (x1, _), kw1, x2, kw2 = train_kernel_inputs(torch, model, gb_train)
        (b1, by1), (b2, by2) = bn_bounds(x1, x2)
        k5, k6, k7, k8 = bnfree_kernel_inputs(torch, gb_train, 128)
        bounds = dict(zip(("K5", "K6", "K7", "K8"), bnfree_bounds(k5, k6, k7, k8)))
        bounds.update(K1=(b1, by1), K2=(b2, by2), K3=(b3, by3), K4=(b4, by4))
        cases = {"K1": (bn.bn_forward_step, dict(x1, **kw1)),
                 "K2": (bn.bn_backward_step, dict(x2, **kw2)),
                 "K3": (fused.propagation_loop, x3), "K4": (fused.propagation_step, x4),
                 "K5": (fused.propagation_loop_bwd, k5), "K6": (fused.train_step, k6),
                 "K7": (fused.train_loop, k7), "K8": (fused.train_loop_bwd, k8)}
        for k, (fn, x) in cases.items():
            dims = wide_dims(k, x)
            info = tiled_plan(k, *dims)
            ws_floats = int(wide_layout(k, *dims)[1]) if info["plan"] == len(plans_of(k)) else 0
            n_rows = (x.get("adjT") if x.get("adjT") is not None else x["y1" if k == "K1"
                      else "y_prev"]).shape[0]
            # launches of milliseconds: a few calls time them, and the profiler's
            # record is printed beside where it returns one (as K9-K17's below)
            ms = timed_ms(torch, lambda: fn(**x), runs=3, reps=1)
            dev_ms = device_ms(torch, lambda: fn(**x), 1, runs=3, required=False)
            dev = "not recorded" if dev_ms is None else f"{dev_ms:.4f} ms"
            say(f"{k} at width 128 ({n_rows} block rows, dims {dims}): {ms:.4f} ms by events, "
                f"device time {dev}, bound {bounds[k][0]:.4f} ms "
                f"({bounds[k][1]}); {describe_k(k, info)}; workspace "
                f"{4 * ws_floats * n_rows} bytes")
    def fwd():
        with torch.no_grad():
            model.forward(gb)
        torch.cuda.synchronize()
    say(f"width 128 full-set forward: {device_ms(torch, fwd, runs=3):.3f} ms of device time")
    for variant in ("bn", "dropout", "clean"):
        m = flagship(torch, "cuda", f"w128_{variant}")

        def step_fn():
            m.training_step(gb_train)
            torch.cuda.synchronize()
        say(f"width 128 '{variant}' training step: {device_ms(torch, step_fn, runs=2):.3f} ms of "
            f"device time")
    wide_two_layer_full_scale(torch, graphs, gb, gb_train)


# phase 18's models beyond the two-layer and typed kernels' staged plans:
# (variant, the wrappers its serving path launches, or None: training only)
WIDE_PATHS = (("w80_h150", ("propagation_loop2", "propagation_step2")),
              ("w80_h150_clean", None), ("w80_h150_bn", None),
              ("w80_composite_bn", ("bnT_forward_step",)),
              ("t33_composite_bn", ("bnT_forward_step",)),
              ("a80_u600_h150", ("propagation_loop2", "propagation_step2")),
              ("a80_u600_h150_clean", None), ("a80_u600_h150_bn", None))
# K9-K15's shapes (D, AL or F, H1) and K16/K17's (D, F, T) of phase 18
WIDE2_SHAPES = ((65, 3, 150), (80, 80, 150), (128, 3, 150), (200, 65, 150), (14, 3, 513),
                (14, 3, 1024), (80, 3, 1024))
WIDE_T_SHAPES = ((65, 3, 4), (80, 80, 3), (128, 3, 4), (200, 65, 2), (14, 3, 33), (14, 3, 40),
                 (80, 3, 33))
DROP_MODES = ((0.1, True), (0.1, False), (0.0, True))


def wide2_cases(torch, gen, W, D, AL, H1, rate, alpha):
    """{kernel: (wrapper with its outputs as a tuple, operands)} of K9-K15 at
    one shape and dropout mode (K12-K15 drop; K9-K11 have no dropout)."""
    from gnn_tpu_torch.ops import bn, fused2
    k9, k10, k12, k13, k11 = random_two_layer_inputs(torch, gen, 2, W, D, AL, H1, 3,
                                                     ("selu", "tanh"), rate, alpha, "cuda")
    f, b = random_bn_inputs(torch, gen, 3, 2, W, D, AL, rate, True, "cuda", H1=H1)
    kw = dict(act0="selu", act1="tanh", alpha_drop=alpha, rate=rate)
    return {"K9": (step2_out, k9), "K10": (fused2.propagation_loop2, k10),
            "K11": (fused2.propagation_loop2_bwd, k11), "K12": (fused2.train_loop2, k12),
            "K13": (fused2.train_loop2_bwd, k13),
            "K14": (bn.bn2_forward_step, dict(f, **kw, threshold=0.05)),
            "K15": (bn.bn2_backward_step, dict(b, **kw))}


def wide_typed_cases(torch, gen, W, D, F, T, rate, alpha):
    """{kernel: (wrapper, operands)} of K16/K17 at one shape and dropout
    mode, the activations cycling through the four kernel activations."""
    from gnn_tpu_torch.ops import typed
    acts = tuple(("selu", "tanh", "relu", "linear")[t % 4] for t in range(T))
    f, b, kw = random_typed_inputs(torch, gen, 3, 2, W, D, F, acts, rate, alpha, True, None,
                                   "cuda")
    return {"K16": (typed.bnT_forward_step, dict(f, **kw, threshold=0.05)),
            "K17": (typed.bnT_backward_step, b)}


def check_wide2_kernel(torch, k, x, label):
    """Kernel k of K9-K17 against its plain version (the reverse kernels
    through check_bwd2), its plan held to the mirror's. Returns the plan."""
    from gnn_tpu_torch.ops import bn, fused2, typed
    info = tiled_plan(k, *wide_dims(k, x))
    label = f"{label}, plan {info['plan']}"
    if k == "K9":
        got, want = against_plain(torch, fused2, "propagation_step2", x)
        check_plain(torch, f"K9 {label}", (got,), (want,), ("out",))
    elif k in ("K10", "K12"):
        name, outs = (("propagation_loop2", ("traj", "margins")) if k == "K10"
                      else ("train_loop2", ("traj", "margins", "agg")))
        check_plain(torch, f"{k} {label}", *against_plain(torch, fused2, name, x), outs,
                    exact=("margins",))
    elif k in ("K14", "K16"):
        mod, name = (bn, "bn2_forward_step") if k == "K14" else (typed, "bnT_forward_step")
        check_plain(torch, f"{k} {label}", *against_plain(torch, mod, name, x),
                    ("y", "agg", "flags", "msum"), summed=("msum",), exact=("flags",))
    else:
        check_bwd2(torch, k, x, label)
    return info["plan"]


def wide_kernels_two_layer(torch, gen):
    """K9-K15 at D, AL (F) 65/80/128/200 and H1 513/1024 (WIDE2_SHAPES), K16/K17
    at D 65-200, F up to 80 and T 33/40 (WIDE_T_SHAPES), W 128 and 32, the
    dropout kernels in the three dropout modes, against their plain
    versions, every wide plan reached; then each wide plan forced at D 14 and
    64 (H1 150, T 4), bit for bit the staged plans'."""
    reached = {}
    for W in (128, 32):
        for shapes, cases in ((WIDE2_SHAPES, wide2_cases), (WIDE_T_SHAPES, wide_typed_cases)):
            for (D, X, Y), (rate, alpha) in itertools.product(shapes, DROP_MODES):
                for k, (_, x) in cases(torch, gen, W, D, X, Y, rate, alpha).items():
                    if k in ("K9", "K10", "K11") and (rate, alpha) != DROP_MODES[0]:
                        continue   # no dropout in these: one mode suffices
                    what = "F={} T={}" if k in ("K16", "K17") else (
                        "F={} H1={}" if k in ("K14", "K15") else "AL={} H1={}")
                    label = f"W={W} D={D} {what.format(X, Y)} rate={rate} alpha={alpha}"
                    reached.setdefault(k, set()).add(check_wide2_kernel(torch, k, x, label))
    for k in sorted(reached, key=lambda k: int(k[1:])):
        if len(plans_of(k)) not in reached[k]:
            fail(f"{k}: the wide cases never reached its wide plan (plans {sorted(reached[k])})")
    say(f"K9-K17 beyond the staged plans' widths: every case within its bounds of the plain "
        f"version; plans reached {dict((k, sorted(v)) for k, v in reached.items())}")
    for W, D, AL in ((128, 14, 3), (128, 64, 3), (32, 14, 3), (32, 64, 64)):
        for rate, alpha in (DROP_MODES[0], DROP_MODES[2]):
            label = f"W={W} D={D} rate={rate}"
            cases = dict(wide2_cases(torch, gen, W, D, AL, 150, rate, alpha))
            cases.update(wide_typed_cases(torch, gen, W, D, AL, N_TYPES, rate, alpha))
            for k, (run, x) in cases.items():
                check_wide_forced(torch, k, run, x, label)
        say(f"K9-K17 wide plans forced at W={W} D={D}: bit-identical to the staged plans")


def wide_two_layer_full_scale(torch, graphs, gb, gb_train):
    """Width 128 at full scale for the two-layer and composite routes (the
    MUTAG-shaped set's graphs and arcs with 128-wide node labels, `graphs`):
    one step each of 'h150', 'h150_clean', 'h150_bn' and 'composite_bn'
    (T = 4) against the CPU, params held to the float64 step where the
    float32 CPU step itself misses; K9-K17 timed at these shapes (the selu
    recipes') against their bounds, with their plans and workspaces. The
    steps run the nets with tanh in place of selu: at this width and scale
    the selu recipes' first-step grads are set-valued at 2.5e-4 to 5.2e-4
    norm-wise (the CPU's own float32 step against its float64 twin), past
    the grads' 2e-4 bound for any float32 computation whose
    near-kink branches differ; tanh has no kink and takes the same routes,
    kernels and plans. And they update with SGD: Adam's first step moves an
    entry by up to lr whatever the size of its gradient, so at this scale a
    gradient within rounding of 0 moves params by more than 1e-5 in one
    float32 computation and not in another (the grads stay held to their
    bound); SGD's params follow the grads."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.ops import bn, fused2, typed
    n_arcs = sum(g.n_arcs for g in graphs)
    for variant in ("h150", "h150_clean", "h150_bn"):
        phase_training(torch, gb_train, n_arcs, f"w128_tanh_{variant}", 1, optimizer="sgd",
                       profile=False)
    typed_gs = typed_graphs(graphs)
    comp = flagship(torch, "cuda", "w128_composite_bn")
    gb_t = comp.to_batch(typed_gs)
    gb_ts = Predictor(comp).build_batch(typed_gs).to("cuda")
    phase_training(torch, gb_t, n_arcs, "w128_tanh_composite_bn", 1, optimizer="sgd",
                   profile=False)
    with torch.no_grad():
        k9, k10, k12, k13 = two_layer_kernel_inputs(torch, gb, gb_train, width=128)
        k11, x14, kw14, x15 = two_layer_train_kernel_inputs(torch, gb_train, width=128)
        (_, x16), kw16, x17, kw17, _ = typed_kernel_inputs(torch, comp, gb_t, gb_ts)
        bounds = dict(zip(("K9", "K10", "K12", "K13"), two_layer_bounds(k9, k10, k12, k13)))
        bounds.update(zip(("K11", "K14", "K15"), two_layer_train_bounds(k11, x14, x15)))
        bounds.update(zip(("K16", "K17"), typed_bounds(x16, x17)))
        cases = {"K9": (step2_out, k9), "K10": (fused2.propagation_loop2, k10),
                 "K11": (fused2.propagation_loop2_bwd, k11), "K12": (fused2.train_loop2, k12),
                 "K13": (fused2.train_loop2_bwd, k13),
                 "K14": (bn.bn2_forward_step, dict(x14, **kw14)),
                 "K15": (bn.bn2_backward_step, x15),
                 "K16": (typed.bnT_forward_step, dict(x16, **kw16)),
                 "K17": (typed.bnT_backward_step, dict(x17, **kw17))}
        for k, (fn, x) in cases.items():
            dims = wide_dims(k, x)
            info = tiled_plan(k, *dims)
            ws_floats = int(wide_layout(k, *dims)[1]) if info["plan"] == len(plans_of(k)) else 0
            rows = next(x[a] for a in ("adjT", "y1", "y_prev") if x.get(a) is not None).shape[0]
            # a launch of milliseconds: events time it; the profiler's record is
            # printed beside where it returns one (it dropped every record of
            # a K11 launch in three tries once)
            ms = timed_ms(torch, lambda: fn(**x), runs=3, reps=1)
            dev_ms = device_ms(torch, lambda: fn(**x), 1, runs=3, required=False)
            dev = "not recorded" if dev_ms is None else f"{dev_ms:.4f} ms"
            say(f"{k} at width 128 ({rows} block rows, dims {dims}): {ms:.4f} ms by events, "
                f"device time {dev}, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}); "
                f"{describe_k(k, info)}; workspace {4 * ws_floats * rows} bytes")


def phase_optimizers(torch, gb, n_arcs):
    """Each of the seven optimizers, and Adam on a cosine schedule, through
    3 steps of the flagship's BatchNorm route (K1/K2, K launches each a step)
    on the card, each step held to the CPU from the same params, BatchNorm
    statistics and masks: iterations equal, the loss within rtol 1e-5, the
    moving statistics within 1e-5, and the optimizer's update: the CPU's
    optimizer, given the card's grads and state, lands within 1e-5 of the
    card's params; the first step's grads as check_first_grads holds every
    path's. Each step starts both from the card's params: the steps of an
    optimizer that is not scale-invariant, as SGD at lr 1e-2 on the
    flagship's loss, diverge, and float32 differences within their bounds
    would grow past 1e-5 along the trajectory. Later steps' grads are not
    held elementwise: where an optimizer moves the params near selu's kink a
    unit's derivative is set-valued, and the card took the other branch than
    both CPU steps at one unit of rmsprop's second or third step (measured
    on one H100), which check_first_grads cannot adjudicate from a float64
    step (check_bwd2 does, per block, in the kernel phases)."""
    import copy
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn
    from gnn_tpu_torch.training.optimizers import make_optimizer, optimizer_config
    say(f"---- optimizers ({elapsed()})")
    gb_cpu = gb.to("cpu")
    K = flagship(torch, "cpu").spec.max_iteration
    configs = [(name, optimizer_config(name)) for name in
               ("adam", "adamw", "sgd", "rmsprop", "adagrad", "lamb", "lion")]
    configs.append(("adam, cosine schedule", optimizer_config("adam", learning_rate={
        "name": "cosine_decay", "kwargs": {"init_value": 1e-3, "decay_steps": 3}})))
    for label, cfg in configs:
        card, cpu = flagship(torch, "cuda", "bn", cfg), flagship(torch, "cpu", "bn", cfg)
        worst = {"loss": 0.0, "bn": 0.0, "grad": 0.0, "params": 0.0}
        times = []
        for i in range(3):
            m = card._draw_masks(card.spec, gb, card.mask_gen)
            before = [p.detach().cpu().clone() for p in core.param_leaves(card.params)]
            bn_before = tree_map(lambda v: v.detach().cpu().clone(), card.bn)
            state = copy.deepcopy(card._opt.state_dict())
            bn.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = card.training_step(gb, masks=m)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if bn.launches != {**dict.fromkeys(bn.launches, 0), "bn_forward_step": K,
                               "bn_backward_step": K}:
                fail(f"optimizer {label} step {i}: launches {bn.launches}")
            # the CPU's step from the same params, statistics and masks
            with torch.no_grad():
                for p, b in zip(core.param_leaves(cpu.params), before):
                    p.copy_(b)
            cpu.bn = tree_map(torch.clone, bn_before)
            ref = cpu.training_step(gb_cpu, masks=tree_map(lambda v: v.cpu(), m))
            if float(ref["iters"]) != float(out["iters"]):
                fail(f"optimizer {label} step {i}: iters {float(out['iters'])} on the card, "
                     f"{float(ref['iters'])} on the CPU")
            worst["loss"] = max(worst["loss"], close_rel(
                torch, out["loss"].cpu(), ref["loss"], 1e-5, 0.0, f"optimizer {label} step {i}"))
            for k, v in flatten(card.bn["state"]).items():
                err = float((v.cpu() - flatten(cpu.bn["state"])[k]).abs().max())
                worst["bn"] = max(worst["bn"], err)
                if err > TOL:
                    fail(f"optimizer {label} step {i}: moving {k} differs by {err:.3e}")
            if i == 0:
                card_g = {k: p.grad.cpu() for k, p in flatten(card.params).items()}
                worst["grad"] = check_first_grads(torch, "bn", card_g, cpu, gb_cpu,
                                                  tree_map(lambda v: v.cpu(), m))
            # the update: the CPU's optimizer on the card's grads and state
            leaves = [b.clone().requires_grad_(True) for b in before]
            for leaf, p in zip(leaves, core.param_leaves(card.params)):
                leaf.grad = p.grad.cpu()
            opt = make_optimizer(cfg, leaves)
            opt.load_state_dict(state)
            opt.step()
            for leaf, p in zip(leaves, core.param_leaves(card.params)):
                err = float((p.detach().cpu() - leaf.detach()).abs().max())
                worst["params"] = max(worst["params"], err)
                if not err <= TOL:
                    fail(f"optimizer {label} step {i}: the CPU's update from the card's grads "
                         f"and state lands {err:.3e} from the card's params")
        say(f"optimizer {label}: 3 steps of the 'bn' route ({[round(t * 1e3, 3) for t in times]} "
            f"ms, host clock), K1/K2 {K} launches each a step; against the CPU from the same "
            f"params: iters equal, loss {worst['loss']:.3e}, moving stats {worst['bn']:.3e}, "
            f"first-step grads {worst['grad']:.3e}, the update from the card's grads and "
            f"state {worst['params']:.3e}")


def ragged_plan(torch, gen, N=20000, E=60000, hub=5, isolated=7, hub_arcs=6000, pads=1000):
    """(src, dst, w, N) of a ragged plan: unsorted random arcs, `hub_arcs`
    of them into node `hub`, none touching node `isolated`, and `pads`
    weight-0 arcs into node N - 1."""
    src = torch.randint(0, N, (E,), generator=gen)
    dst = torch.randint(0, N, (E,), generator=gen)
    dst[torch.randperm(E, generator=gen)[:hub_arcs]] = hub
    src[src == isolated] = isolated + 1
    dst[dst == isolated] = isolated + 1
    w = torch.rand(E, generator=gen) + 0.1
    src = torch.cat([src, torch.zeros(pads, dtype=src.dtype)])
    dst = torch.cat([dst, torch.full((pads,), N - 1, dtype=dst.dtype)])
    w = torch.cat([w, torch.zeros(pads)])
    perm = torch.randperm(len(src), generator=gen)
    return src[perm].numpy(), dst[perm].numpy(), w[perm].numpy(), N


def check_k18(torch, segment, x, plan, label):
    """K18 against its plain version on the same CUDA tensors: within TOL of
    the largest output entry, rows without entries exactly 0, a second launch
    bit-identical; the launch the library makes held to ops/segment.py's
    mirror. Returns the largest difference."""
    got = segment.segment_aggregate(x, plan)
    again = segment.segment_aggregate(x, plan)
    torch.cuda.synchronize()
    want = segment.segment_aggregate_ref(x, plan)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    empty = plan.rowptr[1:] == plan.rowptr[:-1]
    if not bool(torch.isfinite(got).all()) or not err <= TOL * scale:
        fail(f"K18 {label}: differs from its plain version by {err:.3e} (largest entry "
             f"{scale:.3e})")
    if bool((got[empty] != 0).any()):
        fail(f"K18 {label}: a row without entries is not exactly 0")
    if not torch.equal(got, again):
        fail(f"K18 {label}: a second launch on the same inputs differs")
    N, D = x.shape
    info = segment.launch_info(N, D)
    if tuple(info[k] for k in ("vector", "lanes", "rows", "ctas")) != segment._agg_launch(N, D):
        fail(f"K18 {label}: the library launches {info}, ops/segment.py::_agg_launch says "
             f"{segment._agg_launch(N, D)}")
    say(f"K18 {label}: rows {plan.num_rows}, entries {plan.col.shape[0]}, D={D}, "
        f"{int(empty.sum())} empty rows exactly 0, repeat bit-identical, max abs err {err:.3e} "
        f"(largest entry {scale:.3e}); launch as mirrored: float{info['vector']} lanes, "
        f"{info['lanes']} a row, {info['rows']} rows a CTA, {info['ctas']} CTAs, "
        f"{info['registers']} registers a thread")
    return err


def k18_bound(torch, plan, D):
    """(least time, what sets it) of K18 on a plan at width D: the state rows
    the plan reads (pad rows are never read: their weight-0 arcs are dropped),
    every output row written, rowptr, and col and w of each entry; a multiply
    and an add per entry and feature."""
    N, nnz = plan.num_rows, plan.col.shape[0]
    read = int(torch.unique(plan.col).numel())
    return bound(4 * (D * read + N * D + (N + 1) + 2 * nnz), 2 * nnz * D)


def time_k18(torch, segment, x, plan, label):
    """K18's, its plain version's and torch.sparse.mm's device time a call
    (the profiler's records; K18's counted, one a call) on a plan, beside
    K18's bound. Returns the times by name and the bound."""
    N, D = x.shape
    lib = torch.sparse_csr_tensor(plan.rowptr.long(), plan.col.long(), plan.w, size=(N, N))
    lib_err = float((torch.sparse.mm(lib, x) - segment.segment_aggregate_ref(x, plan)).abs().max())
    dev = {"K18": device_ms(torch, lambda: segment.segment_aggregate(x, plan), 1),
           "plain": device_ms(torch, lambda: segment.segment_aggregate_ref(x, plan)),
           "torch.sparse.mm": device_ms(torch, lambda: torch.sparse.mm(lib, x))}
    b, by = k18_bound(torch, plan, D)
    say(f"K18 {label} ({N} rows, {plan.col.shape[0]} entries, D={D}): device time a call "
        f"kernel {dev['K18']:.4f} ms (bound {b:.4f}, {by}; {b / dev['K18']:.0%} of it), plain "
        f"{dev['plain']:.4f} ms, torch.sparse.mm {dev['torch.sparse.mm']:.4f} ms (max abs diff "
        f"{lib_err:.3e} to the plain version)")
    return dev, (b, by)


def phase_segment_kernel(torch, gb):
    """K18 against its plain version on the whole set's plan (forward and
    transpose, D = 14, then D 1/31/64/150) and on a ragged plan; times at D =
    14, 64 and 150 on the forward and transpose plans and on the ragged
    plan's hub, beside torch.sparse.mm on the same CSR matrix, and the plain
    body's index_add_ aggregation."""
    from gnn_tpu_torch.ops import segment
    from gnn_tpu_torch.ops.aggregate import aggregate_to_nodes
    say(f"---- segment kernel K18 ({elapsed()})")
    gen = torch.Generator().manual_seed(SEED)
    Np = gb.n_node_pad
    fwd, bwd = gb.agg_plan.fwd, gb.agg_plan.bwd
    x = torch.randn(Np, 14, generator=gen).cuda()
    err = max(check_k18(torch, segment, x, fwd, "full set, forward"),
              check_k18(torch, segment, x, bwd, "full set, transpose"))
    wide = {}
    for D in (1, 31, 64, 150):
        wide[D] = torch.randn(Np, D, generator=gen).cuda()
        check_k18(torch, segment, wide[D], fwd, "full set, forward")
        check_k18(torch, segment, wide[D], bwd, "full set, transpose")
    src, dst, w, N = ragged_plan(torch, gen)
    plans = segment.build_agg_plan(src, dst, w, N).to("cuda")
    hub = int(plans.fwd.rowptr[6] - plans.fwd.rowptr[5])
    if hub < 5000:
        fail("the ragged plan's hub has fewer than 5000 in-arcs")
    ragged = {}
    for D in (14, 37):
        ragged[D] = torch.randn(N, D, generator=gen).cuda()
        check_k18(torch, segment, ragged[D], plans.fwd,
                  "ragged (hub, isolated node, unsorted), forward")
        check_k18(torch, segment, ragged[D], plans.bwd, "ragged, transpose")

    dev, (b, by) = time_k18(torch, segment, x, fwd, "full set, forward")
    dev_t, _ = time_k18(torch, segment, x, bwd, "full set, transpose")
    for D in (64, 150):
        time_k18(torch, segment, wide[D], fwd, "full set, forward")
        time_k18(torch, segment, wide[D], bwd, "full set, transpose")
    # the ragged plan at D = 14: its time is the hub row's chain of entries
    time_k18(torch, segment, ragged[14], plans.fwd, f"ragged plan, a hub of {hub} in-arcs")
    out = dict(name="K18 segment_aggregate", route="cuda",
               source="gnn_tpu_torch/ops/csrc/segment_agg.cu",
               replaces="gnn_tpu/ops/pallas_segment.py:164", max_abs_err=err,
               ms=dev["K18"], plain_ms=dev["plain"], bound_ms=b, bound_by=by,
               library_ms=dev["torch.sparse.mm"])
    E = gb.n_real[1]
    t_all = device_ms(torch, lambda: aggregate_to_nodes(x[gb.src], gb.edge_w, gb.dst, Np))
    t_real = device_ms(torch, lambda: aggregate_to_nodes(x[gb.src[:E]], gb.edge_w[:E],
                                                         gb.dst[:E], Np))
    say(f"plain body's aggregation (index_add_ over {gb.src.shape[0]} arc slots): "
        f"{t_all:.4f} ms; over the {E} real arcs only: {t_real:.4f} ms (device time)")
    # at this size a call's host work outlasts its kernel, so CUDA events over
    # back-to-back calls time the host; the JSON row takes the device time
    say("CUDA events over back-to-back calls (host-bound at this size): "
        f"K18 {timed_ms(torch, lambda: segment.segment_aggregate(x, fwd)):.4f} ms, transpose "
        f"{timed_ms(torch, lambda: segment.segment_aggregate(x, bwd)):.4f} ms (device "
        f"{dev_t['K18']:.4f}), plain {timed_ms(torch, lambda: segment.segment_aggregate_ref(x, fwd)):.4f} ms")
    return {"K18": out}


def phase_pallas(torch, graphs, gb_cpu, gb, n_arcs):
    """The 'pallas' path: the flagship with aggregation='pallas' on the plan
    batch of the whole set, its forward against the CPU (K18 K launches), a
    32-graph generator batch likewise, then 3 BatchNorm training steps
    (phase_training). Returns K18's launches over the forward and the steps."""
    from gnn_tpu_torch.graphs.generator import GraphDataGenerator
    from gnn_tpu_torch.ops import segment
    say(f"---- 'pallas' path ({elapsed()})")
    model = flagship(torch, "cuda", "pallas")
    cpu = flagship(torch, "cpu", "pallas")
    K = model.spec.max_iteration
    t0 = time.perf_counter()
    small = next(iter(GraphDataGenerator(graphs, batch_size=32, rng=SEED, build_plan=True)))
    say(f"32-graph generator batch: {small.n_real} real (nodes, arcs, targets), pads "
        f"{small.pad_shapes()} ({time.perf_counter() - t0:.2f} s to build)")
    fwd_launches = 0
    for label, b_cpu, b in (("whole set", gb_cpu, gb), ("32-graph batch", small, small.to("cuda"))):
        segment.reset_launches()
        res = model.forward(b)
        torch.cuda.synchronize()
        n = segment.launches["segment_aggregate"]
        if n != K:
            fail(f"'pallas' forward ({label}): K18 launched {n} times, expected {K}")
        if label == "whole set":
            fwd_launches = n
        ref = cpu.forward(b_cpu)
        sel = b_cpu.sel_mask
        out, want = res["out"].cpu()[sel], ref["out"][sel]
        err = float((out - want).abs().max())
        if float(res["iters"]) != float(ref["iters"]) or not err <= TOL \
                or not bool(torch.isfinite(out).all()):
            fail(f"'pallas' forward ({label}): iters {float(res['iters'])} on the card, "
                 f"{float(ref['iters'])} on the CPU; outputs differ by {err:.3e}")
        say(f"'pallas' forward ({label}): K18 {n} launches, iters {float(res['iters'])} equal, "
            f"{out.shape[0]} outputs within {err:.3e} of the CPU")
    forward_time(torch, "pallas", model, gb, n_arcs)
    counted = phase_training(torch, gb, n_arcs, "pallas", 3)
    return fwd_launches + counted["segment_aggregate"]


def engine_graph_key(g):
    """A graph's identity that survives normalize_graphs (arc ids only)."""
    return g.n_nodes, g.arcs[:, :2].tobytes()


def phase_engine(torch, graphs):
    """Phase 20: the flagship trained, evaluated, tested, checkpointed and
    cross-validated by the engine on the card (module docstring)."""
    import shutil
    import tempfile
    say(f"---- engine ({elapsed()})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        engine_checks(torch, graphs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def engine_checks(torch, graphs, tmp):
    import collections
    import types

    import numpy as np
    from gnn_tpu_torch import metrics as mt
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.graphs.graph import split_graphs
    from gnn_tpu_torch.graphs.utils import getindices, prepare_LKO_data
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    t_phase = time.perf_counter()
    mods = (bn, fused, fused2, typed, segment)
    extra = {k: mt.Metrics[k] for k in ("Acc", "Bacc", "Fs")}

    def model_at(device, name):
        return flagship(torch, device, model_kw=dict(extra_metrics=extra,
                                                     path_writer=os.path.join(tmp, name)))

    def counts():
        return {k: v for m in mods for k, v in m.launches.items()}

    def recorder(model, into):
        draw = model._draw_masks

        def record(spec, gb, gen):
            masks = draw(spec, gb, gen)
            into.append(masks)
            return masks
        model._draw_masks = record

    tr, te, va = getindices(len(graphs), 0.7, 0.1, seed=SEED)
    card = model_at("cuda", "card")
    K = card.spec.max_iteration
    t0 = time.perf_counter()
    gTr, gVa, gTe = (card.to_batch([graphs[i] for i in idx]) for idx in (tr, va, te))
    say(f"engine batches: train {len(tr)}, validation {len(va)}, test {len(te)} graphs "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")

    # ---- main path: model.train, counting kernel launches
    drawn, first = [], {}
    recorder(card, drawn)
    step = card.training_step

    def first_step(gb, mean=True, masks=None):
        out = step(gb, mean=mean, masks=masks)
        if not first:
            first.update(out=out, params=tree_map(lambda v: v.detach().clone(), card.params),
                         grads={k: p.grad.clone() for k, p in flatten(card.params).items()})
        return out
    card.training_step = first_step
    for m in mods:
        m.reset_launches()
    t0 = time.perf_counter()
    card.train(gTr, epochs=8, gVa=gVa, update_freq=1, max_fails=3, verbose=0)
    train_s = time.perf_counter() - t0
    launched = {k: n for k, n in counts().items() if n}
    E = len(card.history["Epoch"])
    evals = [gTr, gVa] * E
    want = {"bn_forward_step": K * E, "bn_backward_step": K * E,
            "propagation_loop": sum(b.adj_loop is not None for b in evals),
            "propagation_step": K * sum(b.adj_dep is not None for b in evals)}
    say(f"engine train: {E} epochs in {train_s:.3f} s (host clock), launches {launched}")
    if launched != {k: n for k, n in want.items() if n} or len(drawn) != E:
        fail(f"engine train: launches {launched} over {E} epochs ({len(drawn)} mask draws), "
             f"expected {want}")
    if len({len(v) for v in card.history.values()}) != 1:
        fail(f"engine train: history columns of unequal lengths "
             f"{ {k: len(v) for k, v in card.history.items()} }")

    # ---- (b) epoch 0's step against the CPU with the card's masks
    gTr_cpu = gTr.to("cpu")
    masks0 = tree_map(lambda v: v.cpu(), drawn[0])
    cpu = model_at("cpu", "cpu")
    ref = cpu.training_step(gTr_cpu, masks=masks0)
    if float(ref["iters"]) != float(first["out"]["iters"]):
        fail(f"engine epoch 0: iters {float(first['out']['iters'])} on the card, "
             f"{float(ref['iters'])} on the CPU")
    lerr = close_rel(torch, first["out"]["loss"].cpu(), ref["loss"], 1e-5, 0.0,
                     "engine epoch 0 loss")
    perr = check_params64(torch, "bn", types.SimpleNamespace(params=first["params"]), cpu,
                          first["grads"], gTr_cpu, [masks0])

    # ---- (c) the restored best weights reproduce the best validation loss
    best = card.history["Best Loss Va"][-1]
    again = card.evaluate(gVa)[0]["Loss"]
    if not abs(again - best) <= 1e-6 * abs(best):
        fail(f"engine: evaluate(gVa) after train gives {again!r}, the history's best "
             f"{best!r}")

    # ---- (d) test on the card against the CPU with the card's weights
    got = card.test(gTe)
    score = card.evaluate(gTe)[4]
    top2 = np.sort(score, axis=1)[:, -2:]
    tie = bool(np.any(top2[:, 1] - top2[:, 0] <= 1e-5))
    cpu_t = model_at("cpu", "cpu_t")
    cpu_t.set_weights(*card.get_weights())
    ref_t = cpu_t.test(gTe.to("cpu"))
    if got["It"] != ref_t["It"]:
        fail(f"engine test: It {got['It']} on the card, {ref_t['It']} on the CPU")
    close_rel(torch, torch.tensor(got["Loss"]), torch.tensor(ref_t["Loss"]), 1e-5, 0.0,
              "engine test loss")
    for k in extra:
        if got[k] != ref_t[k] and not tie:
            fail(f"engine test: {k} {got[k]} on the card, {ref_t[k]} on the CPU, no "
                 f"output row within 1e-5 of an argmax tie")

    # ---- (e) checkpoint: one more epoch from the card and from a fresh model
    card.save_checkpoint(os.path.join(tmp, "ck"))
    fresh = model_at("cuda", "fresh")
    fresh.load_checkpoint(os.path.join(tmp, "ck"))
    more = {}
    for name, m in (("card", card), ("fresh", fresh)):
        more[name] = []
        recorder(m, more[name])
        m.train(gTr, epochs=1, gVa=gVa, update_freq=1, max_fails=3, verbose=0)
    (ma,), (mb,) = more["card"], more["fresh"]
    for net in ("state", "output"):
        for pos in ma[net]:
            if not torch.equal(ma[net][pos], mb[net][pos]):
                fail(f"engine checkpoint: the resumed model drew other {net} masks at {pos}")
    cerr = max(float((a - flatten(fresh.params)[k]).detach().abs().max())
               for k, a in flatten(card.params).items())
    if not cerr <= TOL or card.history["Epoch"] != fresh.history["Epoch"]:
        fail(f"engine checkpoint: params {cerr:.3e} apart after one more epoch (epochs "
             f"{card.history['Epoch']} and {fresh.history['Epoch']})")

    # ---- (f) LKO, 3 folds on 300 graphs
    subset = graphs[:300]
    folds = prepare_LKO_data(list(subset), focus="g", number_of_batches=3, useVa=True,
                             seed=SEED + 1)
    keys = [collections.Counter(engine_graph_key(h) for h in split_graphs(g))
            for g in folds[1]]
    if sum(keys, collections.Counter()) != collections.Counter(map(engine_graph_key, subset)):
        fail("engine LKO: the test folds are not disjoint or do not cover the 300 graphs")
    for m in mods:
        m.reset_launches()
    res = model_at("cuda", "lko").LKO(folds, epochs=2, update_freq=1, verbose=0)
    bad = {k: v for k, v in res.items() if len(v) != 3 or not np.all(np.isfinite(v))}
    if bad or not counts()["bn_forward_step"]:
        fail(f"engine LKO: metrics {res}, launches {counts()}")

    # ---- (g) the epoch counters
    rows = [json.loads(x) for x in open(os.path.join(card.path_writer, "Training.jsonl"))]
    secs = [r["value"] for r in rows if r["name"] == "EpochSeconds"]
    eps = [r["value"] for r in rows if r["name"] == "EdgesPerSecond"]
    say(f"engine epochs on {CARD}: EpochSeconds {[round(s, 6) for s in secs]}, "
        f"EdgesPerSecond {[f'{e:.4e}' for e in eps]} ({int(gTr.n_real[1])} arcs an epoch)")
    say(f"engine: epoch 0 vs CPU: iters equal, loss {lerr:.3e}, params {perr:.3e}; best "
        f"validation loss {best:.6f} reproduced ({abs(again - best):.3e}); test It "
        f"{got['It']}, Loss {got['Loss']:.6f} (CPU {ref_t['Loss']:.6f}), "
        f"{ {k: round(got[k], 6) for k in extra} }{' (an argmax tie)' if tie else ''}; "
        f"checkpoint resumed, masks equal, params {cerr:.3e}; LKO 3 folds "
        f"{ {k: [round(x, 4) for x in v] for k, v in res.items()} }; phase "
        f"{time.perf_counter() - t_phase:.1f} s")



LGNN_LAYERS = 5
SERIAL_LAYERS = 3   # phase 21's serial epoch and residual step: the stack's first three
                    # layers (their CPU references, the phase's largest, at a smaller depth to
                    # keep the run in 900 s)


def lgnn_model(torch, device, path_writer, starter=False, layers=LGNN_LAYERS):
    """Phase 21's LGNN: `layers` graph-focus layers at MUTAG widths (14
    node-label, 3 arc-label, 2 target dims), get_state False, get_output True,
    K=5, threshold 0.01, Adam at 1e-3, seeded random weights (layer l from
    seed SEED + l). By default examples/mutag_lgnn.py:38-62's stack:
    hidden-150 two-layer selu state nets without BatchNorm or dropout (state
    widths 14, then 16), readouts of hidden 150 (selu, softmax); with
    `starter`, starter.py:58-96's with focus 'g': one-layer selu state nets
    with AlphaDropout 0.1 at the input and the trailing BatchNorm, softmax
    readouts with dropout 0.1; the stack's masks from a seeded generator."""
    from gnn_tpu_torch import LGNN, GNNgraphBased, MLPSpec, get_inout_dims
    from gnn_tpu_torch import metrics as mt
    hidden = None if starter else 150
    gnns = []
    for layer in range(layers):
        dims = dict(layer=layer, get_state=False, get_output=True)
        in_s, l_s = get_inout_dims("state", 14, 3, 2, "g", 0, hidden, **dims)
        in_o, l_o = get_inout_dims("output", 14, 3, 2, "g", 0, hidden, **dims)
        drop = dict(dropout_rate=(0.1,), dropout_pos=(0,)) if starter else {}
        ss = MLPSpec(input_dim=in_s, units=tuple(l_s), activations="selu",
                     kernel_initializer="lecun_normal", bias_initializer="lecun_normal",
                     batch_normalization=starter, alphadropout=starter, **drop)
        so = MLPSpec(input_dim=in_o, units=tuple(l_o),
                     activations="softmax" if starter else ("selu", "softmax"),
                     kernel_initializer="glorot_normal", bias_initializer="glorot_normal",
                     batch_normalization=False, **drop)
        gnns.append(GNNgraphBased(ss, so, loss_arguments={"from_logits": False}, max_iteration=5,
                                  threshold=0.01, seed=SEED + layer, device=device))
    lgnn = LGNN(gnns, False, True, optimizer={"name": "adam", "kwargs": {"learning_rate": 1e-3}},
                loss_function="categorical_crossentropy", loss_arguments={"from_logits": False},
                extra_metrics={k: mt.Metrics[k] for k in ("Acc", "Bacc", "Fs")},
                path_writer=path_writer)
    lgnn.mask_gen.manual_seed(SEED + 2)     # the same masks every run
    return lgnn


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper of the port (ops/{bn,fused,fused2,typed,segment}.py)
    replaced by its plain version (its name with _ref, the function the
    wrapper runs on the CPU), for float64 twins on the card: the kernels take
    float32 only."""
    import importlib
    saved = []
    for name in ("bn", "fused", "fused2", "typed", "segment"):
        mod = importlib.import_module(f"gnn_tpu_torch.ops.{name}")
        for attr in dir(mod):
            if attr.endswith("_ref") and callable(getattr(mod, attr[:-4], None)):
                saved.append((mod, attr[:-4], getattr(mod, attr[:-4])))
                setattr(mod, attr[:-4], getattr(mod, attr))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def readout_units(torch, switch=None):
    """Records the pre-activation of every selu and softmax the port's MLPs
    apply (the readouts; a state net's activations run in a kernel or its
    plain version) in call order, as (name, tensor), and with `switch` (a
    bool mask a call) takes selu's other derivative branch where the mask is
    set. Yields the list of records. Without `switch` the values and
    gradients are torch's."""
    import torch.nn.functional as F
    from gnn_tpu_torch.ops import mlp
    pre = []

    class Switched(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, flip):
            ctx.save_for_backward(x, flip)
            return F.selu(x)

        @staticmethod
        def backward(ctx, g):
            x, flip = ctx.saved_tensors
            d = torch.where((x > 0) ^ flip, mlp.SELU_SCALE,
                            mlp.SELU_SCALE * mlp.SELU_ALPHA * torch.exp(x.clamp_max(0.0)))
            return g * d, None
    saved = dict(mlp._ACTIVATIONS)

    def selu(x):
        pre.append(("selu", x.detach()))
        return F.selu(x) if switch is None else Switched.apply(x, switch[len(pre) - 1])

    def softmax(x):
        pre.append(("softmax", x.detach()))
        return saved["softmax"](x)
    mlp._ACTIVATIONS.update(selu=selu, softmax=softmax)
    try:
        yield pre
    finally:
        mlp._ACTIVATIONS.update(saved)


@contextlib.contextmanager
def kinks_switched(torch, band):
    """The plain versions' activation derivative (ops/fused.py::_act_grad,
    which every plain reverse step of a state net takes) with selu's branch
    switched at every pre-activation within `band` of the kink. Yields a
    one-element list, the count of switched units."""
    import importlib
    from gnn_tpu_torch.ops import fused, mlp
    plain = fused._act_grad
    count = [0]

    def act_grad(name, h):
        d = plain(name, h)
        if name != "selu":
            return d
        near = h.abs() <= band
        count[0] += int(near.sum())
        other = torch.where(h > 0, mlp.SELU_SCALE * mlp.SELU_ALPHA * torch.exp(h.clamp_max(0.0)),
                            mlp.SELU_SCALE)
        return torch.where(near, other, d)
    saved = []
    for name in ("bn", "fused", "fused2", "typed"):
        mod = importlib.import_module(f"gnn_tpu_torch.ops.{name}")
        if getattr(mod, "_act_grad", None) is plain:
            saved.append((mod, "_act_grad", plain))
            mod._act_grad = act_grad
        for attr in dir(mod):
            fn = getattr(mod, attr)
            if any(d is plain for d in getattr(fn, "__defaults__", None) or ()):
                saved.append((fn, "__defaults__", fn.__defaults__))
                fn.__defaults__ = tuple(act_grad if d is plain else d for d in fn.__defaults__)
            if any(d is plain for d in (getattr(fn, "__kwdefaults__", None) or {}).values()):
                saved.append((fn, "__kwdefaults__", fn.__kwdefaults__))
                fn.__kwdefaults__ = {k: act_grad if d is plain else d
                                     for k, d in fn.__kwdefaults__.items()}
    try:
        yield count
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def stack_twin(torch, make, gb, run, switch=None, band=None):
    """The float64 twin of an LGNN's work: `make(device)`'s stack on the
    batch's device in float64, `run(model, batch)` on the float64 batch with
    the kernels' plain versions (plain_versions), the readouts'
    pre-activations recorded and selu's derivative branch switched there by
    `switch` (readout_units), and with `band` the state nets' selu units
    within it of the kink switched (kinks_switched). Returns {"params",
    "grads": by key on the host, "pre": the recorded pre-activations,
    "switched": the state-net units switched}."""
    from gnn_tpu_torch.convert import flatten
    model = to_float64(torch, make(gb.device.type))
    with (plain_versions(), readout_units(torch, switch) as pre,
          kinks_switched(torch, band) if band else contextlib.nullcontext([0]) as count):
        run(model, batch64(torch, gb))
    flat = flatten(model._params())
    return {"params": {k: p.detach().cpu() for k, p in flat.items()},
            "grads": {k: p.grad.detach().cpu() for k, p in flat.items()}, "pre": pre,
            "switched": count[0]}


def hold_stack(torch, label, card, cpu, pre, twin_of, serial=False, replay=None):
    """An LGNN's grads and params after one step on the card (`card`,
    lgnn_step_result's; a serial epoch: each layer's one step) against the
    CPU's (`cpu`), held by hold_grads and hold_params to the float64 twin
    (`twin_of(switch=None, band=None)` -> stack_twin's result; run once, then
    as needed with the readout units switched where the card's recorded
    pre-activations `pre` lie on the other side of selu's kink than
    float64's, and as hold_grads' witness where the CPU's float32 opens no
    gate: with the state nets' units switched where they lie within the
    float32 rounding of the kink, taken as the largest distance between the
    card's and float64's readout pre-activations). A tensor's set-valued gate
    opens on misses against float64 in the tensors whose reverse feeds it: in
    a parallel or residual step those of every layer above, its own layer's
    readout and, for a state net, itself; in a serial epoch, where each layer
    trains alone, only its own layer's. Returns the largest card-vs-CPU
    differences (grads, params). `replay` as hold_params'."""
    import functools
    from gnn_tpu_torch.convert import parse_key
    twin = functools.cache(lambda: twin_of(None))

    @functools.cache
    def base():
        got = twin()["pre"]
        if [(n, p.shape) for n, p in pre] != [(n, p.shape) for n, p in got]:
            fail(f"{label}: the card's readouts ran {[(n, tuple(p.shape)) for n, p in pre]}, the "
                 f"float64 twin's {[(n, tuple(p.shape)) for n, p in got]}")
        return got

    @functools.cache
    def switched():
        flips = [(a > 0) != (b > 0) if n == "selu" else torch.zeros_like(b, dtype=torch.bool)
                 for (n, a), (_, b) in zip(pre, base())]
        per_call = [int(f.sum()) for (n, _), f in zip(pre, flips) if n == "selu"]
        if not sum(per_call):
            return None
        return {"grads": twin_of(flips)["grads"],
                "units": f"{sum(per_call)} readout units switched, {per_call} by call"}

    def near_kinks():
        band = max((float((a.double() - b).abs().max()) for (_, a), (_, b) in zip(pre, base())),
                   default=0.0)
        if not band:            # no readout: no measure of the rounding
            return twin()["grads"]
        got = twin_of(None, band)
        say(f"{label}: the float64 step with the {got['switched']} state-net units within "
            f"{band:.3e} (the card's largest readout pre-activation distance from float64) of "
            f"selu's kink switched")
        return got["grads"]

    def net(key):
        return parse_key(key)[:2]

    def feeds(key):
        layer, part = net(key)
        return [k for k in cpu["grads"]
                if (net(k)[0] == layer and net(k)[1] in (part, "output"))
                or (not serial and net(k)[0] > layer)]
    gerr = hold_grads(torch, label, card["grads"], cpu["grads"], lambda: twin()["grads"], feeds,
                      switched, ("the float64 step with its state nets' near-kink units switched",
                                 near_kinks))
    perr = hold_params(torch, label, card["params"], cpu["params"], card["grads"],
                       lambda: (twin()["params"], twin()["grads"]), 1, replay)
    return gerr, perr


def lgnn_step_check(torch, label, make, gb, n_arcs, want, mode="parallel"):
    """One training step of `make`'s LGNN in `mode` on the card, counting the
    port's kernel launches (`want`, no other) and recording its readouts'
    pre-activations, against the same step on the CPU with the card's masks:
    realised counts equal, loss rtol 1e-5, moving statistics TOL, grads and
    params as hold_stack holds them. Then 3 more steps timed and profiled.
    Returns the step's host-clock ms."""
    import functools
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.models import lgnn as tlgnn
    card = make("cuda")
    card.training_mode = mode
    masks = tlgnn.draw_masks(card._specs, gb, card.mask_gen)
    before = {k: p.detach().cpu().clone() for k, p in flatten(card._params()).items()}
    reset_port_launches()
    with readout_units(torch) as pre:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = card.training_step(gb, masks=masks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launched = port_launch_counts()
    if launched != want:
        fail(f"{label}: launches {launched}, expected {want}")
    t0 = time.perf_counter()
    cpu = make("cpu")
    cpu.training_mode = mode
    ref = lgnn_step_result(cpu, cpu.training_step(
        gb.to("cpu"), masks=tree_map(lambda v: None if v is None else v.cpu(), masks)))
    cpu_s = time.perf_counter() - t0
    if out["iters"].tolist() != ref["iters"].tolist():
        fail(f"{label}: iters {out['iters'].tolist()} on the card, {ref['iters'].tolist()} on "
             f"the CPU")
    lerr = close_rel(torch, out["loss"].cpu(), ref["loss"], 1e-5, 0.0, f"{label} loss")
    berr = max([float((v.cpu() - ref["bn"][k]).abs().max())
                for k, v in flatten(card._bns()).items()], default=0.0)
    if berr > TOL:
        fail(f"{label}: moving statistics differ from the CPU's by {berr:.3e}")

    def run(model, batch):
        model.training_mode = mode
        model.training_step(batch, masks=masks)
    result = lgnn_step_result(card, out)
    gerr, perr = hold_stack(torch, label, result, ref, pre,
                            lambda switch, band=None: stack_twin(torch, make, gb, run, switch,
                                                                 band),
                            replay=functools.cache(lambda: update64(
                                torch, before, result["grads"], card.optimizer_config)))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.training_step(gb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    say(f"{label}: step {ms:.3f} ms (host clock, synchronized; 3 more "
        f"{[round(t, 3) for t in times]} ms), CPU step {cpu_s:.1f} s; iters "
        f"{out['iters'].tolist()}, loss {float(out['loss']):.6f}; vs CPU: loss {lerr:.3e}, "
        f"moving stats {berr:.3e}, grads {gerr:.3e}, params {perr:.3e}; "
        f"{n_arcs * float(out['iters'].sum()) / (sorted(times)[1] / 1e3):.4e} edges/s "
        f"(all layers' iterations) ({elapsed()})")

    def step():
        card.training_step(gb)
        torch.cuda.synchronize()
    phase_profile(torch, step, runs=3, what=f"{label} step")
    return ms


def lgnn_step_result(model, out):
    """What hold_stack and the step checks read of an LGNN after a step, on
    the host: iters, loss, moving statistics, grads and params by key."""
    from gnn_tpu_torch.convert import flatten
    flat = flatten(model._params())
    return {"iters": out["iters"].cpu(), "loss": out["loss"].cpu(),
            "bn": {k: v.detach().cpu() for k, v in flatten(model._bns()).items()},
            "grads": {k: p.grad.detach().cpu().clone() for k, p in flat.items()},
            "params": {k: p.detach().cpu().clone() for k, p in flat.items()}}


def reset_port_launches():
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    for m in (bn, fused, fused2, segment, typed):
        m.reset_launches()


def port_launch_counts():
    """The port's wrappers' launch counts since the last reset, the nonzero ones."""
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    return {k: n for m in (bn, fused, fused2, segment, typed) for k, n in m.launches.items()
            if n}


def phase_lgnn(torch, graphs, requests, gb_train, n_arcs):
    """Phase 21: the 5-layer hidden-150 LGNN served and trained on the card
    (module docstring)."""
    import shutil
    import tempfile
    say(f"---- LGNN ({elapsed()})")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lgnn_")
    try:
        lgnn_checks(torch, graphs, requests, gb_train, n_arcs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"LGNN phase: {time.perf_counter() - t_phase:.1f} s")


def lgnn_checks(torch, graphs, requests, gb_train, n_arcs, tmp):
    import numpy as np
    from gnn_tpu_torch import Graph, Predictor
    from gnn_tpu_torch.graphs.utils import getindices
    from gnn_tpu_torch.models import lgnn as tlgnn
    L, K = LGNN_LAYERS, 5
    names = iter(range(10 ** 6))

    def make(device, **kw):
        return lgnn_model(torch, device, os.path.join(tmp, f"w{next(names)}") + "/", **kw)

    # ---- (a) Predictor(lgnn): 8 requests against the CPU
    t0 = time.perf_counter()
    card = make("cuda")
    pred, pred_cpu = Predictor(card), Predictor(make("cpu"), device="cpu")
    pred.warmup([r for _, r in requests])
    say(f"LGNN serving: warmup {time.perf_counter() - t0:.2f} s")
    worst, per_request = 0.0, {}
    for name, req in requests:
        glist = [req] if isinstance(req, Graph) else list(req)
        host = pred.build_batch(glist)
        want = {}
        if host.adj_loop is not None:
            want["propagation_loop2"] = L
        if host.adj_dep is not None:
            want["propagation_step2"] = L * K
        reset_port_launches()
        t0 = time.perf_counter()
        out = pred.predict(req)
        ms = (time.perf_counter() - t0) * 1e3
        launched, iters = port_launch_counts(), pred.stats["last_iters"]
        if launched != want or launched.get("propagation_loop2") != L:
            fail(f"LGNN request {name!r}: launches {launched}, expected {want} with K10 {L}")
        ref = pred_cpu.predict(req)
        for o, r in zip(*(([x] if isinstance(req, Graph) else x) for x in (out, ref))):
            if o.shape != r.shape or not np.isfinite(o).all() or not (abs(o - r) <= TOL).all():
                fail(f"LGNN request {name!r}: output differs from the CPU run")
            worst = max(worst, float(abs(o - r).max()))
        if iters != pred_cpu.stats["last_iters"]:
            fail(f"LGNN request {name!r}: iters {iters} on the card, "
                 f"{pred_cpu.stats['last_iters']} on the CPU")
        per_request[name] = ms
        say(f"LGNN request {name!r}: {len(glist)} graphs, {ms:.3f} ms (predict, host clock), "
            f"iters {iters}, launches {launched}")
    say(f"LGNN served outputs vs CPU: max abs diff {worst:.3e} over {len(requests)} requests "
        f"({elapsed()})")
    gb_all = pred.build_batch(graphs).to("cuda")

    def fwd():
        with torch.no_grad():
            r = tlgnn.lgnn_forward(card._specs, card._params(), card._bns(), gb_all, False,
                                   False, True)
        torch.cuda.synchronize()
        return r
    iters = [float(i) for i in fwd()[0]]
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fwd()
        times.append(time.perf_counter() - t0)
    t_med = sorted(times)[5]
    say(f"LGNN full-set forward on {CARD}: {t_med * 1e3:.3f} ms median of 10 (host clock, "
        f"synchronized), iters {iters}, {n_arcs * sum(iters) / t_med:.4e} edges/s (all "
        f"layers' iterations)")
    phase_profile(torch, fwd, what="LGNN full-set forward")

    # ---- (b) one parallel step, (c) one residual step of the stack's first
    # SERIAL_LAYERS layers, against the CPU
    def make_serial(device):
        return make(device, layers=SERIAL_LAYERS)

    def step_want(layers):
        return {"propagation_loop2": layers, "propagation_loop2_bwd": layers,
                "propagation_step2": layers * K}
    lgnn_step_check(torch, "LGNN parallel", make, gb_train, n_arcs, step_want(L))
    lgnn_step_check(torch, "LGNN residual", make_serial, gb_train, n_arcs,
                    step_want(SERIAL_LAYERS), mode="residual")

    # ---- (c) one serial epoch against the CPU, of the stack's first SERIAL_LAYERS layers
    def serial(model, batch):
        model.train(batch, 1, update_freq=1, training_mode="serial", verbose=0)
    card = make_serial("cuda")
    reset_port_launches()
    with readout_units(torch) as pre:
        t0 = time.perf_counter()
        serial(card, gb_train)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    launched = port_launch_counts()
    # a layer: its step, its evaluation and the augmentation by its outputs
    Ls = SERIAL_LAYERS
    want = {"propagation_loop2": 3 * Ls, "propagation_loop2_bwd": Ls,
            "propagation_step2": 3 * Ls * K}
    if launched != want:
        fail(f"LGNN serial epoch: launches {launched}, expected {want}")
    t0 = time.perf_counter()
    cpu = make_serial("cpu")
    serial(cpu, gb_train.to("cpu"))
    cpu_s = time.perf_counter() - t0
    for i, (g, c) in enumerate(zip(card.gnns, cpu.gnns)):
        if g.history["It Tr"] != c.history["It Tr"]:
            fail(f"LGNN serial layer {i}: It {g.history['It Tr']} on the card, "
                 f"{c.history['It Tr']} on the CPU")
        close_rel(torch, torch.tensor(g.history["Loss Tr"]), torch.tensor(c.history["Loss Tr"]),
                  1e-5, 0.0, f"LGNN serial layer {i} loss")
    # each layer's grads are those of its one step
    none = {"iters": torch.zeros(0), "loss": torch.zeros(())}
    gerr, perr = hold_stack(torch, "LGNN serial", lgnn_step_result(card, none),
                            lgnn_step_result(cpu, none), pre,
                            lambda switch, band=None: stack_twin(torch, make_serial, gb_train,
                                                                 serial, switch, band),
                            serial=True)
    say(f"LGNN serial epoch: {card_s:.3f} s on the card (host clock), CPU {cpu_s:.1f} s, "
        f"launches {launched}; per layer It {[g.history['It Tr'] for g in card.gnns]}, loss "
        f"{[round(g.history['Loss Tr'][0], 6) for g in card.gnns]}; vs CPU: grads {gerr:.3e}, "
        f"params {perr:.3e} ({elapsed()})")

    # ---- (d) lgnn.train for up to 5 epochs, then test
    tr, te, va = getindices(len(graphs), 0.7, 0.1, seed=SEED)
    card = make("cuda")
    gTr, gVa, gTe = (card.to_batch([graphs[i] for i in idx]) for idx in (tr, va, te))
    reset_port_launches()
    t0 = time.perf_counter()
    card.train(gTr, 5, gVa, update_freq=1, max_fails=5, training_mode="parallel", verbose=0)
    train_s = time.perf_counter() - t0
    E = len(card.history["Epoch"])
    launched = port_launch_counts()
    if launched.get("propagation_loop2_bwd") != L * E or set(launched) != set(step_want(L)):
        fail(f"LGNN train: {E} epochs, launches {launched}")
    res = card.test(gTe)
    if not all(np.isfinite(v) for v in res.values()):
        fail(f"LGNN test: metrics {res}")
    rows = [json.loads(x) for x in open(os.path.join(card.path_writer, "Training.jsonl"))]
    secs = [r["value"] for r in rows if r["name"] == "EpochSeconds"]
    say(f"LGNN train on {CARD}: {E} epochs in {train_s:.3f} s (host clock), EpochSeconds "
        f"{[round(x, 6) for x in secs]} ({int(gTr.n_real[1])} arcs an epoch), launches "
        f"{launched}; Loss Tr {[round(x, 6) for x in card.history['Loss Tr']]}; test "
        f"{ {k: round(v, 6) for k, v in res.items()} } ({elapsed()})")

    # ---- (e) the starter's LGNN: one parallel step through K1/K2
    lgnn_step_check(torch, "LGNN starter", lambda d: make(d, starter=True), gb_train, n_arcs,
                    {"bn_forward_step": L * K, "bn_backward_step": L * K})


def phase_ift(torch, gb_train, n_arcs):
    """Phase 22: one grad_mode='ift' step of the flagship's clean variant
    (K3 once, K4 K times) and of h150_clean (K10 once, K9 K times), no
    backward kernel (module docstring)."""
    t_phase = time.perf_counter()
    say(f"---- implicit adjoint ({elapsed()})")
    for variant in ("ift_clean", "ift_h150_clean"):
        phase_training(torch, gb_train, n_arcs, variant, 1)
    say(f"IFT phase: {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def one_flip(torch, adj, point="ua"):
    """Within: every bf16 rounding of the bf16 plain versions at `point` (of
    fused2.round_bf16's: "ua", bf(U_a) of K3/K4 and K9-K11; "agg", the
    aggregated slice of K1/K2's x3) has its largest-magnitude entry one bf16
    step larger, one rounding flip an iteration
    (tests/test_torch_bf16_adj.py::one_flip), from which Part B's bound on
    every entry is derived; the entry is taken among the nodes with an arc
    in `adj` where the call's blocks are adj's. A flip reaches later
    iterations only where its change crosses a rounding boundary of bf(s),
    so one flip in a single iteration may move nothing downstream (a
    saturated unit) or a great deal (a cascade)."""
    from gnn_tpu_torch.ops import fused2
    orig, done = fused2.round_bf16, []
    has_arc = (adj.float() != 0).any(dim=-1)[..., None]

    def flip(p, x):
        r = orig(p, x)
        if p != point:
            return r
        done.append(True)
        score = r.abs() * has_arc.to(r.device) if has_arc.shape[:2] == r.shape[:2] else r.abs()
        flat = r.reshape(-1).clone()
        i = int(score.reshape(-1).argmax())
        flat[i] = (flat[i:i + 1].view(torch.int32) + (1 << 16)).view(torch.float32)[0]
        return flat.reshape(r.shape)
    fused2.round_bf16 = flip
    try:
        yield
    finally:
        fused2.round_bf16 = orig
    if not done:
        fail(f"one_flip: no rounding at {point!r} ran")


def hold_bf16(label, got, want, flipped, grads=False):
    """Part B's two-part gate (tests/test_torch_bf16_adj.py::hold): at least
    99% of the entries within 1e-5 of `want` (grads: rtol 2e-4 with a floor
    of 2e-5 of the largest entry), and every entry within the larger of that
    and the one-flip bound max|flipped() - want|, `want` run again with one
    flip. The bound decides only entries beyond the tolerance, so `flipped`
    (a callable) runs and the bound is printed only where there are some.
    Returns the largest difference."""
    import numpy as np

    def a(x):
        return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
    got, want = a(got), a(want)
    tol = (2e-4 * np.abs(want) + 2e-5 * np.abs(want).max()) if grads else np.full(want.shape, TOL)
    if not np.isfinite(got).all():
        fail(f"{label}: non-finite entries")
    err = np.abs(got - want)
    share = float(np.mean(err <= tol)) if err.size else 1.0
    worst = float(err.max()) if err.size else 0.0
    say(f"{label}: {share:.6f} of the {want.size} entries within "
        f"{'rtol 2e-4 (floor 2e-5 of the largest)' if grads else f'{TOL:g}'}, largest "
        f"difference {worst:.3e}")
    if share < 0.99:
        fail(f"{label}: only {share:.4f} of the entries within the tolerance")
    if (err > tol).any():
        bound = float(np.abs(a(flipped()) - want).max())
        say(f"{label}: one-flip bound {bound:.3e} for the {int((err > tol).sum())} entries "
            f"beyond the tolerance")
        if (err > np.maximum(tol, bound)).any():
            fail(f"{label}: {worst:.3e} beyond the one-flip bound {bound:.3e}")
    return worst


def once(fn):
    """fn, run at the first call only: the later calls return its result."""
    kept = []

    def get():
        if not kept:
            kept.append(fn())
        return kept[0]
    return get


def bf16_kernel_inputs(torch, gb16, gbt16):
    """K10_bf16's and K9_bf16's operands as the bf16 h150 serving path forms
    them on the full set (K9's at the first dep step, rT = W0a @ Σres),
    K11_bf16's as the bf16 h150_clean route forms them on the training batch
    (the plain K10_bf16's trajectory, a readout-like cotangent)."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused2
    with torch.no_grad():
        m = flagship(torch, "cuda", "h150")
        spec = m.spec
        K, thr = spec.max_iteration, float(spec.threshold)
        acts = dict(zip(("act0", "act1"), spec.state_spec.activations))
        loop, dep = core.hybrid2_operands(spec, m.params["state"], m.bn["state"], gb16)
        k10 = dict(loop, K=K, threshold=thr, **acts)
        H1 = dep["w20"].shape[0] // 2
        k9 = dict(dep, rT=fused2.seq_dot(core.residual_agg(gb16, dep["s"], exact=True),
                                         dep["w20"][H1:]),
                  **acts)
        c = flagship(torch, "cuda", "h150_clean")
        lt, _ = core.hybrid2_operands(c.spec, c.params["state"], c.bn["state"], gbt16)
        traj, _ = fused2.propagation_loop2_bf16_ref(**dict(lt, K=K, threshold=thr, **acts))
        k11 = dict(adjT=lt["adjT"], s0=lt["s0"], traj=traj, fT=lt["fT"], w20=lt["w20"],
                   w1=lt["w1"], b1=lt["b1"], affine=lt["affine"],
                   g_traj=readout_like(torch, traj, lt["nm"], SEED + 31), **acts)
    return k9, k10, k11


def bf16_bounds(cases):
    """{kernel: (least time, what sets it)} of the bf16 variants `cases`
    ({kernel: operands}): the bf16 adjacency read once (2 bytes an entry),
    each f32 input read once and each output written once, at 3.35 TB/s;
    the products of bf16 operands at the card's dense bf16 tensor-core rate
    (BF16_FLOPS) and the f32 ones (K2_bf16's dw) at its fp32 rate, over the
    arcs present. K9/K10: U (2 * 2H1 * D a node), the aggregation (2 * H1 an
    arc) and h1 (2 * H1 * D a node) an iteration; K11 its forward twice (as
    it runs it) and the reverse products dy0 (2 * H1 * D), dua (2 * H1 an
    arc), dw1 (2 * D * H1), dw20 (2 * 2H1 * D) and gs (2 * 2H1 * D) a node
    and iteration. K3/K4: U (2 * 2H * D a node) and A (2 * H an arc) an
    iteration. K1: the aggregation (2 * D an arc) and the dense layer
    (2 * D * C a node, C = 2D + F + 1); K2: the dense layer again, dx2
    (2 * D * 2D a node), the aggregation's reverse (2 * D an arc) and dw
    (2 * D * C a node, fp32). K12: the aggregation (2 * D an arc), h0
    (2 * H1 * C a node, C = 2D + AL) and h1 (2 * D * H1 a node) an iteration;
    K13 the forward's dense layers once (the aggregation is saved), dy0
    (2 * D * H1 a node), dx3 (2 * H1 * C a node) and ds (2 * D an arc) in
    bf16, dw1 and dw0 in fp32 (the same counts as h1 and h0). K5: K3's
    iteration, dua (2 * H an arc) and gs (2 * 2H * D a node) in bf16, dw2
    (2 * 2H * D a node) in fp32, a reverse iteration. K7: the aggregation
    (2 * D an arc) and h (2 * D * 2D a node) an iteration; K8 h again, dx2
    (2 * 2D * D a node) and ds (2 * D an arc) in bf16, dw (2 * D * 2D a node)
    in fp32, a reverse iteration; K6 K7's iteration once, H wide. K14: the
    aggregation (2 * D an arc), h0 (2 * H1 * C a node, C = 2D + F + 1) and h1
    (2 * D * H1 a node); K15 the dense layers again, dy0 (2 * D * H1 a node),
    dx2 (2 * H1 * 2D a node) and ds (2 * D an arc) in bf16, dw0 and dw1 in
    fp32. K16/K17: K1's and K2's counts (each node its own type's rows), the
    types 4 bytes a node and the per-type affines, coefficients and
    partials T times K1's and K2's."""
    def bound16(nbytes, ops16, ops32=0):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (ops16 / BF16_FLOPS + ops32 / FP32_FLOPS) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def adjs(x):
        a = [x[k] for k in ("adjT", "adj_loop", "adj_dep") if x.get(k) is not None]
        return 2 * sum(t.numel() for t in a), sum(_nnz(t) for t in a)

    out = {}
    for k, x in cases.items():
        adj, nnz = adjs(x)
        if k in ("K9_bf16", "K10_bf16", "K11_bf16"):
            B, W, _ = x["adjT"].shape
            D, H1 = x["w1"].shape
            n, wts = B * W, 4 * (3 * H1 * D + D)
            fwd = 2 * n * (2 * H1 * D + H1 * D) + 2 * H1 * nnz
        if k == "K9_bf16":
            out[k] = bound16(adj + 4 * n * (D + 2 * H1 + D) + wts + 4 * 2 * D, fwd)
        elif k == "K10_bf16":
            K = x["K"]
            out[k] = bound16(adj + 4 * n * (D + H1 + 1) + wts + 4 * 2 * D + 4 * K * n * (D + 1),
                             K * fwd)
        elif k == "K11_bf16":
            K = x["traj"].shape[0]
            rev = 2 * n * (H1 * D + D * H1 + 2 * (2 * H1 * D)) + 2 * H1 * nnz
            out[k] = bound16(adj + 4 * n * (D + H1) + wts + 4 * 2 * K * n * D + 4 * n * (D + H1)
                             + B * wts, K * (2 * fwd + rev))
        elif k in ("K12_bf16", "K13_bf16"):
            B, W, _ = x["adjT"].shape
            D, H1 = x["w1"].shape
            C, n = x["w0"].shape[1], B * W
            K, AL = x["fd"].shape[0], x["fd"].shape[-1]
            keep = 0 if x["ms"] is None else 2 * K * n * D
            wts = 4 * (H1 * C + H1 + D * H1 + D)
            dense = 2 * n * (H1 * C + D * H1)               # h0 and h1 a node
            if k == "K12_bf16":
                out[k] = bound16(adj + keep + wts + 4 * (n * D + K * n * AL + n)
                                 + 4 * K * n * (2 * D + 1), K * (2 * D * nnz + dense))
            else:
                out[k] = bound16(adj + keep + wts + 4 * (n * D + 3 * K * n * D + K * n * AL)
                                 + 4 * (n * D + K * n * AL) + B * wts,
                                 K * (dense + dense + 2 * D * nnz), K * dense)
        elif k in ("K7_bf16", "K8_bf16"):
            B, W, D = x["s0"].shape
            n = B * W
            K = x["K"] if k == "K7_bf16" else x["traj"].shape[0]
            keep = 0 if x["ms"] is None else 2 * K * n * D
            dense = 2 * n * D * 2 * D                        # h (or dx2, dw) a node
            if k == "K7_bf16":
                out[k] = bound16(adj + keep + 4 * (n * D + K * n * D + 2 * D * D + n)
                                 + 4 * K * n * (2 * D + 1), K * (2 * D * nnz + dense))
            else:
                out[k] = bound16(adj + keep + 4 * (n * D + 4 * K * n * D + 2 * D * D)
                                 + 4 * (n * D + K * n * D + B * 2 * D * D),
                                 K * (2 * dense + 2 * D * nnz), K * dense)
        elif k == "K6_bf16":
            B, W, D = x["s"].shape
            H, n = x["fT"].shape[-1], B * W
            rows = 2 + (x["rT"] is not None)
            out[k] = bound16(adj + (0 if x["m"] is None else n * D) + 4 * n * (rows * D + H)
                             + 4 * 2 * H * D + 4 * n * (H + D), 2 * D * nnz + 2 * n * H * 2 * D)
        elif k == "K5_bf16":
            B, W, _ = x["adjT"].shape
            H2, D = x["w2"].shape
            H, n, K = H2 // 2, B * W, x["traj"].shape[0]
            small = 4 * (H2 * D + 2 * H)
            out[k] = bound16(adj + 4 * n * (D + 2 * K * D + D) + small + 4 * 2 * n * D + B * small,
                             K * (2 * n * 2 * H * D + 2 * 2 * H * nnz + 2 * n * 2 * H * D),
                             K * 2 * n * 2 * H * D)
        elif k in ("K3_bf16", "K4_bf16"):
            B, W, _ = x["adjT"].shape
            H2, D = x["w2"].shape
            H, n = H2 // 2, B * W
            ops = 2 * n * 2 * H * D + 2 * H * nnz
            small = 4 * (H2 * D + 2 * H)
            if k == "K3_bf16":
                K = x["K"]
                out[k] = bound16(adj + 4 * n * (2 * D + 1) + small + 4 * K * n * (D + 1), K * ops)
            else:
                rows = D + (2 if x["rT"] is not None else 1) * H + H
                out[k] = bound16(adj + 4 * n * rows + small, ops)
        elif k in ("K14_bf16", "K15_bf16"):
            y = x["y1"] if k == "K14_bf16" else x["y_prev"]
            R, W, D = y.shape
            H1, C = x["w0_aug"].shape
            F, n = x["feats"].shape[-1], R * W
            wts = H1 * C + D * H1 + D
            shared = adj + (0 if x["keep"] is None else n * (C - 1)) + 4 * (n * F + wts + n)
            dense = 2 * n * (H1 * C + D * H1)               # h0 and h1 a node
            if k == "K14_bf16":
                rt = 0 if x["rT"] is None else 4 * n * D
                out[k] = bound16(shared + 4 * (2 * n * D + 4 * D) + rt
                                 + 4 * (2 * n * D + n + R * D), 2 * D * nnz + dense)
            else:
                out[k] = bound16(shared + 4 * (5 * n * D + 9 * D + 1)
                                 + 4 * (2 * n * D + R * wts + 2 * R * D),
                                 dense + 2 * n * (D * H1 + H1 * 2 * D) + 2 * D * nnz, dense)
        else:
            y = x["y1"] if k in ("K1_bf16", "K16_bf16") else x["y_prev"]
            R, W, D = y.shape
            F = x["feats"].shape[-1]
            C, n = 2 * D + F + 1, R * W
            T = x["w_stk"].shape[0] // D if "w_stk" in x else 1      # K16/K17: types 4 a node
            shared = (adj + (0 if x["keep"] is None else n * (C - 1))
                      + 4 * (n * F + T * D * C + n + (n if "types" in x else 0)))
            if k == "K16_bf16":
                rt = 0 if x["rT"] is None else 4 * n * D
                out[k] = bound16(shared + 4 * (2 * n * D + 4 * T * D) + rt
                                 + 4 * (2 * n * D + n + R * T * D), 2 * D * nnz + 2 * D * C * n)
            elif k == "K17_bf16":
                out[k] = bound16(shared + 4 * (5 * n * D + 9 * T * D + 1)
                                 + 4 * (2 * n * D + R * T * D * C + 2 * R * T * D),
                                 2 * D * nnz + 2 * D * C * n + 2 * D * 2 * D * n,
                                 2 * D * C * n)
            elif k == "K1_bf16":
                rt = 0 if x["rT"] is None else 4 * n * D
                out[k] = bound16(shared + 4 * (2 * n * D + 4 * D) + rt
                                 + 4 * (2 * n * D + n + R * D), 2 * D * nnz + 2 * D * C * n)
            else:
                out[k] = bound16(shared + 4 * (5 * n * D + 9 * D + 1)
                                 + 4 * (2 * n * D + R * D * C + 2 * R * D),
                                 2 * D * nnz + 2 * D * C * n + 2 * D * 2 * D * n,
                                 2 * D * C * n)
    return out


def check_bf16_kernels(torch, cases):
    """Each bf16 variant against its plain version on the card on the same
    inputs, by Part B's gate (hold_bf16, the bound from the plain version
    with one flip at the case's rounding point); movement flags equal.
    The outputs named summed are summed over the blocks (K11_bf16's
    per-block partials); each output's largest difference goes into
    BF16_OUT_ERR. `cases`: (kernel, module,
    wrapper, operands, output names, rounding point, the summed outputs,
    whether its outputs are gradients). Returns {kernel: largest
    difference}."""
    worst = {}
    for k, module, name, x, names, point, summed, grads in cases:
        got, want = against_plain(torch, module, name, x)
        got, want = ((t,) if torch.is_tensor(t) else t for t in (got, want))

        def run_flipped(module=module, name=name, x=x, point=point):
            with one_flip(torch, bf16_flip_adj(torch, x), point):
                r = getattr(module, name + "_ref")(**x)
            return (r,) if torch.is_tensor(r) else r
        flipped = once(run_flipped)
        worst[k] = 0.0
        for i, (o, a, b) in enumerate(zip(names, got, want)):
            if a is None:
                continue
            if o in ("margins", "flags"):
                if not bool((a == b).all()) and not (
                        k == "K10_bf16" and near_threshold_flags(torch, x, got, want)):
                    fail(f"{k}: {o} disagree with its plain version")
                continue
            if o in summed:
                a, b = a.sum(0), b.sum(0)
            err = hold_bf16(f"{k} {o} vs its plain version", a, b,
                            lambda i=i, s=o in summed: flipped()[i].sum(0) if s else flipped()[i],
                            grads=grads)
            BF16_OUT_ERR[k, o] = err
            worst[k] = max(worst[k], err)
        say(f"{k}: largest difference from its plain version {worst[k]:.3e}"
            f"{' (bit for bit)' if worst[k] == 0.0 else ''}")
    return worst


def near_threshold_flags(torch, x, got, want):
    """Whether every movement flag in which K10_bf16's margins (got[1])
    differ from its plain version's (want[1]) belong to a node the plain
    version puts at the threshold: its ||s_k - s_{k-1}|| and thr *
    ||s_{k-1}||, evaluated in float64 on the plain version's states, apart
    by no more than the f32 rounding of the two norms ((D / 2 + 2) f32
    units of their sum: a D-term sum of squares, its square root and the
    product with thr). The tensor cores add in another order than the plain
    version, so such a node may fall on either side. Prints each such node
    and its distance."""
    wtraj, wmarg = (t.double() for t in want)
    marg = got[1].double()
    s0 = x["s0"].double()
    eps = 2.0 ** -24 * (s0.shape[-1] / 2 + 2)

    def states(tr, k):     # (s_k, s_{k-1}) that margins[k] compares, s_{-1} = 1
        s = s0 if k == 0 else tr[k - 1]
        return s, torch.ones_like(s0) if k == 0 else s0 if k == 1 else tr[k - 2]
    ok = True
    for k, b, n in (marg != wmarg).nonzero().tolist():
        s, s_old = (v[b, n] for v in states(wtraj, k))
        dist, lim = float((s - s_old).norm()), float(x["threshold"] * s_old.norm())
        band = eps * (dist + lim)
        say(f"K10_bf16: movement flag of node {n} of block {b} before iteration {k} differs "
            f"from its plain version's: ||s_k - s_k-1|| - thr ||s_k-1|| = {dist - lim:.3e} in "
            f"float64 on the plain version's states, the f32 rounding there {band:.3e}")
        ok = ok and abs(dist - lim) <= band
    return ok


def bf16_flip_adj(torch, x):
    """The adjacency whose arcs one_flip's entry is taken among: a kernel's
    adjT, or the BatchNorm kernels' block rows [loop | dep]."""
    if "adjT" in x:
        return x["adjT"]
    return torch.cat([a for a in (x["adj_loop"], x["adj_dep"]) if a is not None])


@contextlib.contextmanager
def bn_cotangent(torch, record, feed=None):
    """Within: the BN training loop's backward (ops/bn.py::_BNTrainLoop)
    appends its state cotangent, the readout's, to `record` (on the CPU)
    and, with `feed`, takes feed in its place."""
    from gnn_tpu_torch.ops import bn
    orig = bn._BNTrainLoop.__dict__["backward"]

    def backward(ctx, g_iters, g_state, g_moms):
        record.append(g_state.detach().cpu().clone())
        if feed is not None:
            g_state = feed.to(g_state.device)
        return orig.__func__(ctx, g_iters, g_state, g_moms)
    bn._BNTrainLoop.backward = staticmethod(backward)
    try:
        yield
    finally:
        bn._BNTrainLoop.backward = orig


def phase_training_bf16(torch, gbt16, n_arcs, variant="h150_clean", route="h150_clean_bf16",
                        point="ua", steps=3):
    """A training path on a bf16 batch: `steps` steps of the flagship
    `variant` (flagship(): the composite flagship's too) on the card,
    counted (ROUTES[route], no other kernel), the
    params finite after them. Step 1 against the CPU from the same weights
    and masks: iterations equal, the loss within rtol 1e-5, the moving
    BatchNorm statistics (where the state net has them) and every grad
    tensor by Part B's gate with the bound of the CPU's step with one flip at
    `point` an iteration (the CPU's bf16 steps are slow, so the later steps
    run on the card alone). On the BatchNorm route the CPU's BN backward
    takes the card's state cotangent (bn_cotangent), which is held to the
    CPU's own within TOL: the readout's exp and matrix products differ from
    the CPU's in the last bit, each such difference can flip a bf(dh)
    rounding of K2_bf16, and the batch moments spread a flip to every grad
    (up to 3e-4 on the card), so fed the same cotangent the two
    backwards are compared on the same bits. Then 3 more steps under the
    profiler (device time by kernel). Returns the launch counts."""
    from gnn_tpu_torch.convert import flatten
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    model = flagship(torch, "cuda", variant)
    gb_cpu = gbt16.to("cpu")
    adj = torch.cat([a for a in (gb_cpu.adj_loop, gb_cpu.adj_dep) if a is not None])
    K = model.spec.max_iteration
    say(f"---- training path '{variant}' on the bf16 batch ({elapsed()})")
    for mod in (bn, fused, fused2, typed, segment):
        mod.reset_launches()
    log, masks, times, first, card_g = [], [], [], None, []
    for i in range(steps):
        m = model._draw_masks(model.spec, gbt16, model.mask_gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with bn_cotangent(torch, card_g) if i == 0 else contextlib.nullcontext():
            out = model.training_step(gbt16, masks=m)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        masks.append(tree_map(lambda v: v.cpu(), m))
        log.append((float(out["iters"]), out["loss"].cpu()))
        if i == 0:
            first = {k: p.grad.detach().cpu().clone() for k, p in flatten(model.params).items()}
            first.update({f"moving {k}": v.cpu().clone()
                          for k, v in flatten(model.bn["state"]).items()})
    launches = {**bn.launches, **fused.launches, **fused2.launches, **typed.launches,
                **segment.launches}
    say(f"'{variant}' bf16 launches over {steps} steps: {launches}")
    for key, n in launches.items():
        per_step = ROUTES[route].get(key, 0)
        if n != steps * (K if per_step == "K" else per_step):
            fail(f"'{variant}' bf16 path: {key} launched {n} times in {steps} steps")
    say(f"training step '{variant}' bf16: {sorted(times)[len(times) // 2] * 1e3:.3f} ms median "
        f"of {steps} (host clock, synchronized; each {[round(t * 1e3, 3) for t in times]} ms), "
        f"{n_arcs * log[0][0] / sorted(times)[len(times) // 2]:.4e} edges/s, iters "
        f"{[r[0] for r in log]}")

    cpu_g = []

    def cpu_step(flip):
        cpu = flagship(torch, "cpu", variant)
        with (one_flip(torch, adj, point) if flip else contextlib.nullcontext()), \
                bn_cotangent(torch, cpu_g, card_g[0] if card_g and not flip else None):
            out = cpu.training_step(gb_cpu, masks=masks[0])
        return out, {**{k: p.grad.clone() for k, p in flatten(cpu.params).items()},
                     **{f"moving {k}": v.clone() for k, v in flatten(cpu.bn["state"]).items()}}
    t0 = time.perf_counter()
    out, cpu = cpu_step(False)
    flipped = once(lambda: cpu_step(True)[1])
    if card_g:
        err = float((card_g[0] - cpu_g[0]).abs().max())
        say(f"'{variant}' bf16 step 0: the readout's state cotangent on the card vs the CPU: "
            f"max abs diff {err:.3e}, {int((card_g[0] != cpu_g[0]).sum())} of "
            f"{card_g[0].numel()} entries differing; the CPU's BN backward takes the card's")
        if err > TOL:
            fail(f"'{variant}' bf16 step 0: the readout's state cotangent differs by {err:.3e}")
    if float(out["iters"]) != log[0][0]:
        fail(f"'{variant}' bf16 step 0: iters {log[0][0]} on the card, {float(out['iters'])} "
             f"on the CPU")
    close_rel(torch, log[0][1], out["loss"], 1e-5, 0.0, f"'{variant}' bf16 step 0 loss")
    for key in cpu:
        moving = key.startswith("moving ")
        hold_bf16(f"'{variant}' bf16 {'' if moving else 'grad '}{key}", first[key], cpu[key],
                  lambda key=key: flipped()[key], grads=not moving)
    for p in core.param_leaves(model.params):
        if not bool(torch.isfinite(p).all()):
            fail(f"'{variant}' bf16 path: non-finite parameters after {steps} steps")
    say(f"'{variant}' bf16 step 0 vs CPU ({time.perf_counter() - t0:.1f} s): iters equal, loss "
        f"within rtol 1e-5, grads and moving statistics within Part B's gate; losses of the "
        f"{steps} steps on the card {[round(float(r[1]), 4) for r in log]}")
    def step():
        model.training_step(gbt16, masks=model._draw_masks(model.spec, gbt16, model.mask_gen))
        torch.cuda.synchronize()
    phase_profile(torch, step, runs=3, what=f"'{variant}' bf16 training step")
    return launches


def phase_state_bf16(torch, graphs, requests, gb, gb_train, gb_train_typed, n_arcs, kernels):
    """Phase 23: state_dim > 0 on the flagship's routes and the bf16
    adjacency of the hidden-150 recipe (module docstring). Returns the
    kernels line's entries of K9_bf16, K10_bf16 and K11_bf16."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.ops import fused2
    t_phase = time.perf_counter()
    say(f"---- state_dim {STATE_DIM} and the bf16 adjacency ({elapsed()})")
    sd = f"s{STATE_DIM}_"
    phase_serving(torch, f"{sd}flagship", flagship(torch, "cuda", f"{sd}bn"),
                  flagship(torch, "cpu", f"{sd}bn"), gb, requests,
                  ("propagation_loop", "propagation_step"), n_arcs)
    for variant in ("bn", "dropout", "h150", "h150_clean"):
        phase_training(torch, gb_train, n_arcs, sd + variant, 1, profile=False)
    phase_training(torch, gb_train_typed, n_arcs, sd + "composite_bn", 1, profile=False)
    say(f"state_dim {STATE_DIM} paths: {time.perf_counter() - t_phase:.1f} s")

    # ---- the bf16 adjacency
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    gb16 = Predictor(flagship(torch, "cpu", "h150"), adj_dtype=bf16).build_batch(graphs).to("cuda")
    gbt16 = flagship(torch, "cuda", "h150_clean").to_batch(graphs, adj_dtype=bf16)
    say(f"bf16 batches: serving {gb16.adj_loop.shape[0]} loop and {gb16.adj_dep.shape[0]} dep "
        f"blocks ({2 * gb16.adj_loop[0].numel()} adjacency bytes a block), training "
        f"{gbt16.adj_loop.shape[0]} loop and {gbt16.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    with torch.no_grad():
        k9, k10, k11 = bf16_kernel_inputs(torch, gb16, gbt16)
        cases = (("K9_bf16", fused2, "propagation_step2_bf16", k9, ("out",), "ua", (), False),
                 ("K10_bf16", fused2, "propagation_loop2_bf16", k10, ("traj", "margins"), "ua",
                  (), False),
                 ("K11_bf16", fused2, "propagation_loop2_bwd_bf16", k11,
                  ("gs", "dw20", "dw1", "db1", "dfT", "daff"), "ua",
                  ("dw20", "dw1", "db1", "daff"), True))
        errs = check_bf16_kernels(torch, cases)
        check_repeat(torch, "K10_bf16", fused2.propagation_loop2_bf16, k10, "full set")
        timed, bounds = time_bf16_kernels(torch, cases, kernels, ("K9", "K10", "K11"))
    served = phase_serving(
        torch, "h150_bf16", flagship(torch, "cuda", "h150"), flagship(torch, "cpu", "h150"), gb16,
        requests, ("propagation_loop2_bf16", "propagation_step2_bf16"), n_arcs,
        predictor_kw={"adj_dtype": bf16}, hold=served_bf16_hold(torch))
    trained = phase_training_bf16(torch, gbt16, n_arcs)
    say(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return kernel_rows(
        kernels, {"K9_bf16": ("fused2_bf16.cu", "K9", served, "propagation_step2_bf16"),
                  "K10_bf16": ("loop2_bf16.cu", "K10", served, "propagation_loop2_bf16"),
                  "K11_bf16": ("eval_loop2_bwd_bf16.cu", "K11", trained,
                               "propagation_loop2_bwd_bf16")}, errs, timed, bounds)


def flagship_bf16_kernel_inputs(torch, gb16, gbt16):
    """K3_bf16's and K4_bf16's operands as the bf16 flagship serving path
    forms them on the full set (K4's at the first dep step, rT = Wa @ Σres
    by seq_dot), K1_bf16's and K2_bf16's as its BN training step forms them
    on the bf16 training batch (train_kernel_inputs: iteration 2 and the
    reverse of iteration 2, with the flagship's AlphaDropout masks and
    residual arcs)."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops.fused2 import seq_dot
    m = flagship(torch, "cuda")
    spec = m.spec
    K, thr, act = spec.max_iteration, float(spec.threshold), spec.state_spec.activations[0]
    with torch.no_grad():
        loop, dep, Wa = core.hybrid_operands(spec, m.params["state"], m.bn["state"], gb16)
        k3 = dict(loop, K=K, threshold=thr, activation=act)
        k4 = dict(dep, rT=seq_dot(core.residual_agg(gb16, dep["s"], exact=True), Wa),
                  activation=act)
    (_, x1), kw, x2, kwb = train_kernel_inputs(torch, m, gbt16)
    return k3, k4, dict(x1, **kw), dict(x2, **kwb)


def check_forward_launches(torch, route, model, gb):
    """One full-set forward of `model` on `gb` launches the wrappers of
    ROUTES[route] as often as it says (K: once an iteration) and no other
    kernel."""
    from gnn_tpu_torch.ops import bn, fused, fused2, segment, typed
    mods = (bn, fused, fused2, typed, segment)
    for mod in mods:
        mod.reset_launches()
    model.forward(gb)
    torch.cuda.synchronize()
    counts = {k: n for mod in mods for k, n in mod.launches.items()}
    K = model.spec.max_iteration
    for key, n in counts.items():
        want = ROUTES[route].get(key, 0)
        if n != (K if want == "K" else want):
            fail(f"'{route}' full-set forward: {key} launched {n} times")
    say(f"'{route}' full-set forward launches: { {k: n for k, n in counts.items() if n} }")


def phase_flagship_bf16(torch, graphs, requests, n_arcs, kernels):
    """Phase 24: the flagship on a bf16 adjacency (module docstring). Returns
    the kernels line's entries of K3_bf16, K4_bf16, K1_bf16 and K2_bf16."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.ops import bn, fused
    t_phase = time.perf_counter()
    say(f"---- the flagship on the bf16 adjacency ({elapsed()})")
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    gb16 = Predictor(flagship(torch, "cpu"), adj_dtype=bf16).build_batch(graphs).to("cuda")
    gbt16 = flagship(torch, "cuda").to_batch(graphs, adj_dtype=bf16)
    say(f"bf16 batches: serving {gb16.adj_loop.shape[0]} loop and {gb16.adj_dep.shape[0]} dep "
        f"blocks, training {gbt16.adj_loop.shape[0]} loop and {gbt16.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    k3, k4, k1, k2 = flagship_bf16_kernel_inputs(torch, gb16, gbt16)
    with torch.no_grad():
        cases = (("K3_bf16", fused, "propagation_loop_bf16", k3, ("traj", "margins"), "ua", (),
                  False),
                 ("K4_bf16", fused, "propagation_step_bf16", k4, ("out",), "ua", (), False),
                 ("K1_bf16", bn, "bn_forward_step_bf16", k1, ("y", "agg", "flags", "msum"), "agg",
                  ("msum",), False),
                 ("K2_bf16", bn, "bn_backward_step_bf16", k2, ("ds", "dw", "dagg", "red"), "dh",
                  ("dw", "red"), True))
        errs = check_bf16_kernels(torch, cases)
        timed, bounds = time_bf16_kernels(torch, cases, kernels, ("K3", "K4", "K1", "K2"))
    model = flagship(torch, "cuda")
    check_forward_launches(torch, "flagship_bf16", model, gb16)
    served = phase_serving(
        torch, "flagship_bf16", model, flagship(torch, "cpu"), gb16, requests,
        ("propagation_loop_bf16", "propagation_step_bf16"), n_arcs,
        predictor_kw={"adj_dtype": bf16}, hold=served_bf16_hold(torch))
    trained = phase_training_bf16(torch, gbt16, n_arcs, "bn", "bn_bf16", "agg")
    say(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    return kernel_rows(
        kernels, {"K3_bf16": ("eval_loop_bf16.cu", "K3", served, "propagation_loop_bf16"),
                  "K4_bf16": ("eval_loop_bf16.cu", "K4", served, "propagation_step_bf16"),
                  "K1_bf16": ("bn_bf16.cu", "K1", trained, "bn_forward_step_bf16"),
                  "K2_bf16": ("bn_bf16.cu", "K2", trained, "bn_backward_step_bf16")},
        errs, timed, bounds)


def train_bf16_kernel_inputs(torch, gbt16):
    """K12_bf16's operands as the bf16 'h150' route forms them on the bf16
    training batch (dropout2_operands with the model's keep-masks), K13_bf16's
    from the plain K12_bf16's trajectory and aggregations with a
    readout-like cotangent; K5_bf16's from the bf16 'clean' route's K3_bf16
    operands (hybrid_operands), the plain K3_bf16's trajectory and a
    readout-like cotangent."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused, fused2
    m = flagship(torch, "cuda", "h150")
    spec = m.spec
    K, thr = spec.max_iteration, float(spec.threshold)
    with torch.no_grad():
        masks = m._draw_masks(spec, gbt16, torch.Generator(device="cuda").manual_seed(SEED + 41))
        loop, _, kw = core.dropout2_operands(spec, m.params["state"], gbt16, masks["state"][0])
        k12 = dict(loop, K=K, threshold=thr, **kw)
        traj, _, agg = fused2.train_loop2_bf16_ref(**k12)
        k13 = dict({k: loop[k] for k in ("adjT", "s0", "ms", "ma", "fd", "w0", "b0", "w1", "b1")},
                   traj=traj, agg=agg, g_traj=readout_like(torch, traj, loop["nm"], SEED + 42),
                   **kw)
        c = flagship(torch, "cuda", "clean")
        act = c.spec.state_spec.activations[0]
        lc, _, _ = core.hybrid_operands(c.spec, c.params["state"], c.bn["state"], gbt16)
        traj3, _ = fused.propagation_loop_bf16_ref(**lc, K=K, threshold=thr, activation=act)
        k5 = dict({k: lc[k] for k in ("adjT", "s0", "fT", "w2", "affine")}, traj=traj3,
                  g_traj=readout_like(torch, traj3, lc["nm"], SEED + 43), activation=act)
    return k12, k13, k5


def phase_train_bf16(torch, graphs, n_arcs, kernels):
    """Phase 25: training on the bf16 adjacency (module docstring): the
    hidden-150 recipe with its dropout (route 'dropout2': K12_bf16/K13_bf16)
    and the clean flagship (route 'hybrid': K3_bf16/K4_bf16 with K5_bf16 and
    K4's f32 backward). Returns the kernels line's entries of K12_bf16,
    K13_bf16 and K5_bf16."""
    from gnn_tpu_torch.ops import fused, fused2
    t_phase = time.perf_counter()
    say(f"---- training on the bf16 adjacency ({elapsed()})")
    t0 = time.perf_counter()
    gbt16 = flagship(torch, "cuda", "h150").to_batch(graphs, adj_dtype=torch.bfloat16)
    say(f"bf16 training batch: {gbt16.adj_loop.shape[0]} loop and {gbt16.adj_dep.shape[0]} dep "
        f"blocks ({time.perf_counter() - t0:.2f} s to pack and upload)")
    k12, k13, k5 = train_bf16_kernel_inputs(torch, gbt16)
    with torch.no_grad():
        cases = (("K12_bf16", fused2, "train_loop2_bf16", k12, ("traj", "margins", "agg"), "x3",
                  (), False),
                 ("K13_bf16", fused2, "train_loop2_bwd_bf16", k13,
                  ("gs", "dw0", "db0", "dw1", "db1", "dfd"), "dh0", ("dw0", "db0", "dw1", "db1"),
                  True),
                 ("K5_bf16", fused, "propagation_loop_bwd_bf16", k5, ("gs", "dw2", "dfT", "daff"),
                  "ua", ("dw2", "daff"), True))
        errs = check_bf16_kernels(torch, cases)
        timed, bounds = time_bf16_kernels(torch, cases, kernels, ("K12", "K13", "K5"))
    h150 = phase_training_bf16(torch, gbt16, n_arcs, "h150", "h150_bf16", "x3")
    clean = phase_training_bf16(torch, gbt16, n_arcs, "clean", "clean_bf16", "ua")
    say(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    return kernel_rows(
        kernels, {"K12_bf16": ("train_loop2_bf16.cu", "K12", h150, "train_loop2_bf16"),
                  "K13_bf16": ("train_loop2_bf16.cu", "K13", h150, "train_loop2_bwd_bf16"),
                  "K5_bf16": ("eval_loop_bwd_bf16.cu", "K5", clean, "propagation_loop_bwd_bf16")},
        errs, timed, bounds)


def dropout_bf16_kernel_inputs(torch, gbt16, gbf16):
    """K7_bf16's operands as the bf16 'dropout' route forms them on the bf16
    training batch (dropout_operands with the model's keep-masks), K8_bf16's
    from the plain K7_bf16's trajectory and aggregations with a
    readout-like cotangent, K6_bf16's at the route's first dep step (the
    state slice dropped, the raw residual aggregation summed exactly) there
    and on the all-dep batch `gbf16` ('flat_dropout')."""
    from gnn_tpu_torch.models import core
    from gnn_tpu_torch.ops import fused
    m = flagship(torch, "cuda", "dropout")
    spec = m.spec
    masks = core.draw_masks(spec, gbt16, torch.Generator(device="cuda").manual_seed(SEED + 51))
    with torch.no_grad():
        loop, _, kw = core.dropout_operands(spec, m.params["state"], gbt16, masks["state"][0])
        k7 = dict(loop, K=spec.max_iteration, threshold=float(spec.threshold), **kw)
        traj, _, agg = fused.train_loop_bf16_ref(**k7)
        k8 = dict({k: loop[k] for k in ("adjT", "s0", "ms", "ma", "fT", "w_cat")}, traj=traj,
                  agg=agg, g_traj=readout_like(torch, traj, loop["nm"], SEED + 52), **kw)
    return (k7, k8, dep_step_operands(torch, m, gbt16, SEED + 53),
            dep_step_operands(torch, flagship(torch, "cuda", "flat_dropout"), gbf16, SEED + 54))


def phase_dropout_bf16(torch, graphs, n_arcs, kernels):
    """Phase 26: the flagship's BatchNorm-free dropout route on the bf16
    adjacency (module docstring): K7_bf16/K8_bf16 once and K6_bf16 K times a
    step on the loop/dep layout, K6_bf16 K times on the all-dep layout.
    Returns the kernels line's entries of K7_bf16, K8_bf16 and K6_bf16."""
    from gnn_tpu_torch.graphs.batch import from_graphs_blocked
    from gnn_tpu_torch.ops import fused
    t_phase = time.perf_counter()
    say(f"---- the dropout route on the bf16 adjacency ({elapsed()})")
    t0 = time.perf_counter()
    gbt16 = flagship(torch, "cuda", "dropout").to_batch(graphs, adj_dtype=torch.bfloat16)
    gbf16 = from_graphs_blocked(graphs, block_w=128, focus="g",
                                adj_dtype=torch.bfloat16).to("cuda")
    say(f"bf16 training batches: {gbt16.adj_loop.shape[0]} loop and {gbt16.adj_dep.shape[0]} "
        f"dep blocks; all-dep {gbf16.adj_dep.shape[0]} ({time.perf_counter() - t0:.2f} s to "
        f"pack and upload)")
    k7, k8, k6, k6f = dropout_bf16_kernel_inputs(torch, gbt16, gbf16)
    with torch.no_grad():
        cases = (("K7_bf16", fused, "train_loop_bf16", k7, ("traj", "margins", "agg"), "agg", (),
                  False),
                 ("K8_bf16", fused, "train_loop_bwd_bf16", k8, ("gs", "dw", "dfT"), "dh", ("dw",),
                  True),
                 ("K6_bf16", fused, "train_step_bf16", k6, ("y", "agg"), "agg", (), False))
        errs = check_bf16_kernels(torch, cases + (
            ("K6_bf16 all-dep", fused, "train_step_bf16", k6f, ("y", "agg"), "agg", (), False),))
        timed, bounds = time_bf16_kernels(torch, cases, kernels, ("K7", "K8", "K6"))
        flat_ms = device_ms(torch, lambda: fused.train_step_bf16(**k6f), launches=1, runs=20)
        b, by = bf16_bounds({"K6_bf16": k6f})["K6_bf16"]
        say(f"K6_bf16 at the all-dep shape adjT {tuple(k6f['adjT'].shape)}: {flat_ms:.4f} ms a "
            f"call (device time), bound {b:.4f} ms ({by}); {CARD}")
    # each path counts its wrappers' launches: the f32 K6-K8 launch 0 times
    trained = phase_training_bf16(torch, gbt16, n_arcs, "dropout", "dropout_bf16", "agg")
    phase_training_bf16(torch, gbf16, n_arcs, "flat_dropout", "flat_dropout_bf16", "agg",
                        steps=1)
    say(f"phase 26: {time.perf_counter() - t_phase:.1f} s")
    return kernel_rows(
        kernels, {"K7_bf16": ("train_loop_bf16.cu", "K7", trained, "train_loop_bf16"),
                  "K8_bf16": ("train_loop_bf16.cu", "K8", trained, "train_loop_bwd_bf16"),
                  "K6_bf16": ("train_loop_bf16.cu", "K6", trained, "train_step_bf16")},
        errs, timed, bounds)


def bn2_typed_bf16_kernel_inputs(torch, gbt16, gbc16, gbs16):
    """K14_bf16's and K15_bf16's operands as the bf16 'h150_bn' step forms
    them on the bf16 training batch (train_kernel_inputs: iteration 2 and its
    reverse, the model's AlphaDropout masks and residual arcs), K16_bf16's
    and K17_bf16's as the bf16 'composite_bn' step forms them on the bf16
    typed training batch, and K16_bf16's of the composite serving path's
    second iteration on the bf16 serving batch (typed_kernel_inputs)."""
    (_, x14), kw, x15, kwb = train_kernel_inputs(torch, flagship(torch, "cuda", "h150_bn"), gbt16)
    (_, x16), kwt, x17, kwtb, (ev, kwe) = typed_kernel_inputs(
        torch, composite_model(torch, "cuda"), gbc16, gbs16)
    return (dict(x14, **kw), dict(x15, **kwb), dict(x16, **kwt), dict(x17, **kwtb),
            dict(ev, **kwe))


def phase_bn2_typed_bf16(torch, graphs, n_arcs, kernels):
    """Phase 27: the two-layer BatchNorm route and composite models on the
    bf16 adjacency (module docstring): K14_bf16/K15_bf16 K times an 'h150_bn'
    step, K16_bf16 K times a composite request, K16_bf16/K17_bf16 K times a
    'composite_bn' step. Returns the kernels line's entries of K14_bf16,
    K15_bf16, K16_bf16 and K17_bf16."""
    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.ops import bn, typed
    t_phase = time.perf_counter()
    say(f"---- the two-layer BatchNorm route and composite models on the bf16 adjacency "
        f"({elapsed()})")
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    typed_set = typed_graphs(graphs)
    gbt16 = flagship(torch, "cuda", "h150_bn").to_batch(graphs, adj_dtype=bf16)
    gbc16 = composite_model(torch, "cuda").to_batch(typed_set, adj_dtype=bf16)
    gbs16 = Predictor(composite_model(torch, "cpu"), adj_dtype=bf16).build_batch(
        typed_set).to("cuda")
    say(f"bf16 batches: h150_bn training {gbt16.adj_loop.shape[0]} loop and "
        f"{gbt16.adj_dep.shape[0]} dep blocks, composite training {gbc16.adj_loop.shape[0]} + "
        f"{gbc16.adj_dep.shape[0]}, composite serving {gbs16.adj_loop.shape[0]} + "
        f"{gbs16.adj_dep.shape[0]} ({time.perf_counter() - t0:.2f} s to pack and upload)")
    k14, k15, k16, k17, k16s = bn2_typed_bf16_kernel_inputs(torch, gbt16, gbc16, gbs16)
    with torch.no_grad():
        cases = (("K14_bf16", bn, "bn2_forward_step_bf16", k14, ("y", "agg", "flags", "msum"),
                  "agg", (), False),
                 ("K15_bf16", bn, "bn2_backward_step_bf16", k15,
                  ("ds", "dw0", "dw1", "db1", "dagg", "red"), "dh0", (), True),
                 ("K16_bf16", typed, "bnT_forward_step_bf16", k16, ("y", "agg", "flags", "msum"),
                  "agg", (), False),
                 ("K17_bf16", typed, "bnT_backward_step_bf16", k17, ("ds", "dw", "dagg", "red"),
                  "dh", (), True))
        # every output unsummed, the per-block partials (msum, red, dw0, dw1,
        # db1, dw) too: bit for bit, but K15_bf16's ds and red, which read
        # the contraction, a product the tensor cores add in their own order
        # (Part B's gate)
        errs = check_bf16_kernels(torch, cases + (
            ("K16_bf16 serving", typed, "bnT_forward_step_bf16", k16s,
             ("y", "agg", "flags", "msum"), "agg", (), False),))
        for k, err in errs.items():
            if err != 0.0 and k != "K15_bf16":
                fail(f"{k}: {err:.3e} from its plain version, not bit for bit")
        for o in ("dw0", "dw1", "db1", "dagg"):
            if BF16_OUT_ERR["K15_bf16", o] != 0.0:
                fail(f"K15_bf16: {o} {BF16_OUT_ERR['K15_bf16', o]:.3e} from its plain version, "
                     f"not bit for bit")
        check_repeat(torch, "K15_bf16", bn.bn2_backward_step_bf16, k15, "full set")
        timed, bounds = time_bf16_kernels(torch, cases, kernels, ("K14", "K15", "K16", "K17"))
        serve_ms = device_ms(torch, lambda: typed.bnT_forward_step_bf16(**k16s), launches=1,
                             runs=20)
        b, by = bf16_bounds({"K16_bf16": k16s})["K16_bf16"]
        say(f"K16_bf16 at the composite serving batch ({k16s['y1'].shape[0]} rows, rate 0): "
            f"{serve_ms:.4f} ms a call (device time), bound {b:.4f} ms ({by}); {CARD}")
    h150_bn = phase_training_bf16(torch, gbt16, n_arcs, "h150_bn", "h150_bn_bf16", "agg")
    comp = composite_model(torch, "cuda")
    phase_serving(torch, "composite_bf16", comp, composite_model(torch, "cpu"), gbs16,
                  [(name, typed_set[i]) for name, i in request_picks(graphs)],
                  ("bnT_forward_step_bf16",), n_arcs,
                  per_request={"bnT_forward_step_bf16": comp.spec.max_iteration},
                  predictor_kw={"adj_dtype": bf16}, hold=served_bf16_hold(torch, "agg"))
    composite = phase_training_bf16(torch, gbc16, n_arcs, "composite_bn", "composite_bn_bf16",
                                    "agg")
    say(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return kernel_rows(
        kernels, {"K14_bf16": ("bn2_bf16.cu", "K14", h150_bn, "bn2_forward_step_bf16"),
                  "K15_bf16": ("bn2_bf16.cu", "K15", h150_bn, "bn2_backward_step_bf16"),
                  "K16_bf16": ("bn_typed_bf16.cu", "K16", composite, "bnT_forward_step_bf16"),
                  "K17_bf16": ("bn_typed_bf16.cu", "K17", composite, "bnT_backward_step_bf16")},
        errs, timed, bounds)


def time_bf16_kernels(torch, cases, kernels, twins):
    """(timed {kernel: (device ms a call, plain ms)}, bounds) of the bf16
    variants `cases` (check_bf16_kernels'), each printed beside its f32
    twin's time (kernels[twin]["ms"], None where not measured)."""
    bounds = bf16_bounds({k: x for k, _, _, x, *_ in cases})
    timed = {}
    for (k, module, name, x, *_), twin in zip(cases, twins):
        fn, ref = getattr(module, name), getattr(module, name + "_ref")
        ms = device_ms(torch, lambda: fn(**x), launches=1, runs=20)
        plain = timed_ms(torch, lambda: ref(**x), runs=3, reps=1)
        timed[k] = (ms, plain)
        b, by = bounds[k]
        t32 = kernels[twin]["ms"]
        say(f"{k}{REDESIGNED.get(k, '')}: {ms:.4f} ms a call (device time), its f32 twin {twin} "
            f"{'not measured' if t32 is None else f'{t32:.4f} ms'} on the f32 batch's same "
            f"blocks; plain version {plain:.3f} ms; bound {b:.4f} ms ({by}); {CARD}")
    return timed, bounds


def kernel_rows(kernels, src, errs, timed, bounds):
    """The kernels line's entries of bf16 variants: src {kernel: (source
    file, f32 twin, launch counts, wrapper)}; each must have launched on its
    main path."""
    out = {}
    for k, (cu, twin, counts, key) in src.items():
        if not counts[key]:
            fail(f"{k}: launched 0 times on its main path")
        out[k] = {"name": k + REDESIGNED.get(k, ""), "route": "cuda",
                  "source": f"gnn_tpu_torch/ops/csrc/{cu}",
                  "replaces": kernels[twin]["replaces"],
                  "launches": counts[key], "max_abs_err": errs[k], "ms": timed[k][0],
                  "plain_ms": timed[k][1], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "library_ms": None}
    return out


def served_bf16_hold(torch, point="ua"):
    """phase_serving's hold for the bf16 path: the request's outputs on the
    card against the CPU's by Part B's gate, the bound from the CPU's
    predictor with one flip at `point` an iteration (bf(U_a) of K3/K4 and
    K9/K10, x3's aggregated slice of K16)."""
    import numpy as np

    def cat(xs):
        return np.concatenate([np.asarray(x).ravel() for x in xs])

    def hold(label, req, outs, refs, pred_cpu):
        def flipped():
            gb = pred_cpu.build_batch([req] if not isinstance(req, list) else req)
            adj = torch.cat([a for a in (gb.adj_loop, gb.adj_dep) if a is not None])
            with one_flip(torch, adj if point != "ua" else gb.adj_loop, point):
                out = pred_cpu.predict(req)
            return cat([out] if not isinstance(req, list) else out)
        return hold_bf16(label, cat(outs), cat(refs), flipped)
    return hold


def main():
    import torch
    phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phases(torch)


def request_picks(graphs):
    """The serving phases' 8 requests as (name, index or slice of `graphs`):
    the whole set, three of 32 graphs, the first graph over 128 nodes, the
    largest graph, a small one and the first 32 again."""
    big = [i for i, g in enumerate(graphs) if g.n_nodes > 128]
    largest = max(range(len(graphs)), key=lambda i: graphs[i].n_nodes)
    return [("all", slice(None)), ("32a", slice(0, 32)), ("32b", slice(32, 64)),
            ("32c", slice(64, 96)), ("big", big[0]), ("largest", largest), ("small", 1),
            ("32a again", slice(0, 32))]


def phases(torch):
    import dataclasses

    from gnn_tpu_torch import Predictor
    from gnn_tpu_torch.graphs.datasets import mutag_shaped
    from gnn_tpu_torch.graphs.generator import GraphDataGenerator

    t0 = time.perf_counter()
    graphs = mutag_shaped(seed=SEED)
    n_nodes = sum(g.n_nodes for g in graphs)
    n_arcs = sum(g.n_arcs for g in graphs)
    big = [i for i, g in enumerate(graphs) if g.n_nodes > 128]
    say(f"data: {len(graphs)} graphs, {n_nodes} nodes, {n_arcs} arcs, {len(big)} graphs "
        f"over 128 nodes ({time.perf_counter() - t0:.2f} s)")
    model = flagship(torch, "cuda")

    picks = request_picks(graphs)
    requests = [(name, graphs[i]) for name, i in picks]

    t0 = time.perf_counter()
    gb = Predictor(model).build_batch(graphs).to("cuda")
    say(f"full-set batch: {gb.n_node_pad // gb.block_w} blocks, {gb.adj_loop.shape[0]} loop, "
        f"{0 if gb.adj_dep is None else gb.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    if gb.adj_dep is None:
        fail("the full set has no residual-coupled blocks: K4 and K9 would not run")
    t0 = time.perf_counter()
    gb_train = model.to_batch(graphs)
    say(f"training batch: {gb_train.n_node_pad // gb_train.block_w} blocks, "
        f"{gb_train.adj_loop.shape[0]} loop rows, {gb_train.adj_dep.shape[0]} dep "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    typed = typed_graphs(graphs)
    comp = composite_model(torch, "cuda")
    t0 = time.perf_counter()
    gb_typed = Predictor(comp).build_batch(typed).to("cuda")
    gb_train_typed = comp.to_batch(typed)
    say(f"composite batches (T={comp.spec.n_types}): serving and training "
        f"({time.perf_counter() - t0:.2f} s to pack and upload)")
    t0 = time.perf_counter()
    gb_plan_cpu = next(iter(GraphDataGenerator(graphs, batch_size=len(graphs), shuffle=False,
                                               build_plan=True)))
    gb_plan = gb_plan_cpu.to("cuda")
    say(f"plan batch (no blocks): {gb_plan.n_real} real (nodes, arcs, targets), pads "
        f"{gb_plan.pad_shapes()}, plan entries {gb_plan.agg_plan.fwd.col.shape[0]} "
        f"({time.perf_counter() - t0:.2f} s to merge, pad, plan and upload)")
    with torch.no_grad():   # the model's params are trainable leaves
        kernels = phase_kernels(torch, model, gb)
        kernels.update(phase_two_layer_kernels(torch, gb, gb_train))
        kernels.update(phase_typed_kernels(torch, comp, gb_train_typed, gb_typed))
        kernels.update(phase_segment_kernel(torch, gb_plan))

    # ---- serving paths: the flagship through K3/K4, the hidden-150 recipe
    # through K10/K9
    served = {label: phase_serving(torch, label, flagship(torch, "cuda", variant),
                                   flagship(torch, "cpu", variant), gb, requests, expect, n_arcs)
              for label, variant, expect in (
                  ("flagship", "bn", ("propagation_loop", "propagation_step")),
                  ("h150", "h150", ("propagation_loop2", "propagation_step2")))}
    # ---- the composite flagship through K16, K = 5 launches a request
    served["composite"] = phase_serving(
        torch, "composite", composite_model(torch, "cuda"), composite_model(torch, "cpu"), gb_typed,
        [(name, typed[i]) for name, i in picks], ("bnT_forward_step",), n_arcs,
        per_request={"bnT_forward_step": comp.spec.max_iteration})
    # ---- the flagship on batches without blocks: the plain body, no kernel
    phase_serving(torch, "unblocked", flagship(torch, "cuda"), flagship(torch, "cpu"),
                  dataclasses.replace(gb_plan, agg_plan=None), requests, (), n_arcs,
                  predictor_kw={"blocked": False})

    # ---- training: one batch of the whole set for every path
    kernels.update(phase_train_kernels(torch, model, gb_train))
    kernels.update(phase_bnfree_kernels(torch, gb_train))
    with torch.no_grad():
        kernels.update(phase_two_layer_train_kernels(torch, gb_train))
    counted = {variant: phase_training(torch, gb_train, n_arcs, variant, steps)
               for variant, steps in (("bn", 5), ("dropout", 5), ("clean", 3), ("h150", 4),
                                      ("h150_clean", 3), ("h150_bn", 3))}
    counted["composite_bn"] = phase_training(torch, gb_train_typed, n_arcs, "composite_bn", 3)
    phase_flat_layout(torch, graphs, typed, requests, n_arcs,
                      {k: kernels[k]["ms"] for k in ("K4", "K6", "K9")})
    phase_one_type(torch, gb, gb_train)
    phase_wide(torch)
    phase_optimizers(torch, gb_train, n_arcs)
    k18_launches = phase_pallas(torch, graphs, gb_plan_cpu, gb_plan, n_arcs)
    phase_engine(torch, graphs)
    phase_lgnn(torch, graphs, requests, gb_train, n_arcs)
    phase_ift(torch, gb_train, n_arcs)
    kernels.update(phase_state_bf16(torch, graphs, requests, gb, gb_train, gb_train_typed, n_arcs,
                                    kernels))
    kernels.update(phase_flagship_bf16(torch, graphs, requests, n_arcs, kernels))
    kernels.update(phase_train_bf16(torch, graphs, n_arcs, kernels))
    kernels.update(phase_dropout_bf16(torch, graphs, n_arcs, kernels))
    kernels.update(phase_bn2_typed_bf16(torch, graphs, n_arcs, kernels))
    for k, (path, key) in {"K1": ("bn", "bn_forward_step"), "K2": ("bn", "bn_backward_step"),
                           "K3": ("flagship", "propagation_loop"),
                           "K4": ("flagship", "propagation_step"),
                           "K5": ("clean", "propagation_loop_bwd"),
                           "K6": ("dropout", "train_step"), "K7": ("dropout", "train_loop"),
                           "K8": ("dropout", "train_loop_bwd"),
                           "K9": ("h150", "propagation_step2"),
                           "K10": ("h150", "propagation_loop2"),
                           "K11": ("h150_clean", "propagation_loop2_bwd"),
                           "K12": ("h150", "train_loop2"),
                           "K13": ("h150", "train_loop2_bwd"),
                           "K14": ("h150_bn", "bn2_forward_step"),
                           "K15": ("h150_bn", "bn2_backward_step"),
                           "K16": ("composite_bn", "bnT_forward_step"),
                           "K17": ("composite_bn", "bnT_backward_step")}.items():
        kernels[k]["launches"] = (served if k in ("K3", "K4", "K9", "K10") else counted)[path][key]
    kernels["K18"]["launches"] = k18_launches
    say(f"clean training path: K3 {counted['clean']['propagation_loop']} and K4 "
        f"{counted['clean']['propagation_step']} launches; h150_clean training path: K10 "
        f"{counted['h150_clean']['propagation_loop2']} and K9 "
        f"{counted['h150_clean']['propagation_step2']} (the JSON line counts the serving paths'); "
        f"composite serving path: K16 {served['composite']['bnT_forward_step']} (the JSON line "
        f"counts the composite_bn training path's); 'pallas' path: K18 {k18_launches} (the "
        f"whole-set forward and 3 training steps)")
    say(f"all phases passed ({elapsed()} of a 900 s time limit; the build took "
        f"{BUILD_S[0]:.1f} s)")
    kernels = {k: kernels[k] for k in sorted(kernels, key=lambda k: (int(k[1:].split("_")[0]), k))}
    # the time the main paths lose in each kernel against its bound, the
    # measure by which the next kernels to redesign are chosen
    loss = {k: v["launches"] * (v["ms"] - v["bound_ms"]) for k, v in kernels.items()}
    say("launches x (ms - bound ms), largest first: "
        + ", ".join(f"{k} {loss[k]:.2f}" for k in sorted(loss, key=loss.get, reverse=True)))
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: v[k] for k in order} for v in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gnn_tpu_torch")):
        fail(f"gnn_tpu_torch not found beside {os.path.basename(__file__)}: "
             "run from a checkout of the repository")
    sys.path.insert(0, here)
    main()
