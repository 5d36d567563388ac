#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tritd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  0. require CUDA; turn TF32 off; print the card, its power limit and versions.
  1. build the hand-written kernel (csrc/elementwise_block*.cu, eight files,
     one nvcc process each, all at once) and print the build's seconds.
  2. hold each of the kernel's 82 variants against its plain PyTorch
     version on the card: float32 and float64 at the taxi, video, a ragged
     and a one-element shape and at the slab shapes phases 12-14 run (a
     half, a padded third and a quarter of taxi along mode 1, a quarter of
     video along mode 3), with and without T'; the 48 narrow variants (storage
     in bf16, float16, float8_e4m3fn or float8_e5m2, masked or not, an
     einsum dtype alone, and storage and einsum in two different narrow
     dtypes) with float32 compute at the taxi, video and half-taxi shapes,
     with float64 compute at the taxi shape, where T' must also be bitwise
     the narrow_cast of D - O' + Y_L'/muL_next from the kernel's own stored
     O' and Y_L'. The 32 variants that store or form T' in the other wide
     dtype (float64 beside float compute, float32 beside double), or T' in
     the compute dtype beside other storage, at the taxi shape, and float32
     storage at float64 compute at video too; their float32 and float64
     outputs within rtol 1e-6 of the plain version, T' bitwise as above.
     Then each narrow variant once on inputs that put its
     outputs at the edges of the narrow formats (448, 464, past 464, 480,
     57344, 61440, +-inf, the float8 and float16 subnormals, the float64
     values one rounding and two round apart): every store bitwise the
     plain version's on the CPU, NaN where it has NaN; the same for all 256
     codes of e4m3fn and of e5m2 as D, E, Y_L and Y_O through every variant
     that holds the format. The kernel's division by a launch's mu (a
     reciprocal made once, div.rn's correction per element) against '/' bit
     for bit: every float32 numerator and 2**28 float64 ones, for the
     presets' annealed mu, their sums, powers of two and all-ones
     significands from 2**-32 to 2**31.
     Time the plain version and the kernel with CUDA events, the card
     asleep while the host enqueues each batch of the kernel, so that they
     hold the card's time; at taxi through both of its entries (the
     pointer entry, which the solve's CUDA graph launches, is the record's
     ms; the by-value entry, which the eager routes launch, its
     by_value_ms), elsewhere through the by-value entry; beside the least
     time the card could take, the host's enqueue time per call and one
     device-to-device copy_ of the same bytes. Then the cases the kernel's design can get wrong, each
     against the plain version at the same tolerances: 1, 7, 8, 9, 255, 257
     elements and an odd count above one wave of groups; views whose
     pointers are 4-byte (float32), 2-byte (bf16) or 1-byte (float8) but not
     16-byte aligned (and a double stream beside float compute, a float one
     beside double);
     the two sums bitwise equal over 20 calls; two streams launching the
     kernel at once, 50 turns. Every variant's pointer entry (the penalties
     read from device memory, the form the CUDA graph of the solve replays)
     on each of the variant's inputs above: every store and both sums
     bitwise its by-value entry's. Every variant's batched entry (B entries
     in one launch, a penalty and two sums an entry: the form phase 22's
     graph replays) at 3 entries of taxi, of 17x23x31 (n * itemsize no
     multiple of 16: entries 1 and 2 take the one-element path) and of
     17x23x31 with every stream starting so far into its buffer that entry
     0's addresses are not 16-byte aligned and entry 1's are: each
     entry's stores and sums bitwise the pointer entry's launch on it
     alone; then timed at 4 x taxi against 4 pointer launches, the card
     asleep while the host enqueues, beside the batch's bound. Phase 22's
     variants at its shapes (f32 at 4 x video and 4 x 100x100x2016, bf16
     storage and f64 at 4 x video) are also held against the plain
     version, `_block_torch(..., batched=True)`, at the single entries'
     tolerances and bitwise to 4 pointer launches, and timed.
  3. the main path: robust TriTD-ADMM on the taxi completion stand-in
     (100x100x500, r=5, 10% missing, COMPLETION_TRITD, 100 iterations, f32),
     checked against a float64 CPU rerun of its first 10 iterations, and on
     the video stand-in (240x320x300, VIDEO_TRITD, 100 iterations); then
     taxi and highway with storage_dtype="bfloat16", taxi with
     einsum_dtype="bfloat16", and masked taxi in float32 and bf16 storage,
     each held to its float32 run's RRE within 0.03; then the four taxi
     solves again with float64 compute, 20 iterations each. Then the other
     narrow dtypes (NARROW_SOLVES): taxi with float16 storage, float16
     einsum and masked float16 storage, highway with float16 storage (each
     within 0.03 of its float32 run's RRE), highway with e5m2 and e4m3fn
     storage, taxi with e5m2 storage, e4m3fn einsum, e5m2 einsum, float16
     storage with a bf16 einsum and bf16 storage with an e4m3fn einsum,
     100 iterations; float64 compute, 20 iterations: float16 and e5m2
     storage at taxi, e4m3fn at highway; the reference's float32/float64
     cases at taxi, 100 iterations: float32 storage, float32 einsum,
     float64 storage (also masked) at float32 compute, a float64 einsum and
     float32 storage at float64 compute, the last also on highway for 20
     iterations; then, cut to 10 iterations (4, and 2 on highway, for the
     32 variants of PR 11), one
     solve for each variant that no run before launched on finite data: on
     highway for a variant that rounds to e4m3fn (masked ones with 10% of
     highway missing), else on taxi. Taxi reaches 526.1, past e4m3fn's
     range: each of the taxi solves above that rounds D or T to e4m3fn is
     NaN from its first iteration, as the reference's is, and the run
     asserts that. The first 10 iterations of each of these solves are held
     to the same solve on the CPU in the same dtypes where both are finite
     (NO_FEEDBACK_RTOL; where a narrow value feeds back into the factor
     solves, an einsum dtype or masked narrow storage, FEEDBACK_RTOL of that
     dtype); a float8 einsum on highway diverges within a few iterations,
     and then both runs must turn non-finite within the 10. A control plants
     a fault (T' rounded toward zero) in the CPU run of a float8-einsum solve
     and fails unless it moves the entries past the limit. A float8 solve
     may turn non-finite after the held iterations; float8 RREs are printed,
     not held to the float32 family (the reference promises no such bound).
     The CPU runs (these references, the controls and taxi's float64 rerun)
     go to CPU_REF_WORKERS spawned worker processes of CPU_REF_THREADS
     threads each as the card solves end, and are held when they return:
     after phase 25 (`phase3 checks took`), so that they overlap the card's
     later phases.
  4. the completion CLI in a subprocess.
  5. checkpointed resume: a subprocess dies right after its step-25
     checkpoint (exit 17); the resume here is bitwise equal to an
     uninterrupted checkpointed run and within rtol 1e-6 of tritd_admm.
     Both run on the graph route (one device-form loop a call, one
     iteration a replay): every launch through the pointer entry; their
     launches join the kernels line.
  6. the other solvers: tritd_admm_outlier on the highway stand-in,
     tritd_als and tritd_mals on the taxi stand-in, each on its graph
     route.
  7. the video CLI in a subprocess at 240x320x300, 100 iterations.
  8. the SVT routes on the card, float32, at 100x50000 and 1000x5000: gram,
     a warm refresh and the svd route with gesvdj's SVD against the svd route
     (the Jacobi kernel) within 1e-4 of ||M||, and
     lowrank:64 on a matrix with 20 components above the gate; the host
     proximal library must have built; times of the torch.linalg calls the
     baselines lean on (eigh, svd, the batched complex svd of prox_tnn).
  9. the eigh drivers of ops/device_linalg.py at the SVT baselines' taxi
     sizes against torch.linalg on the same matrices (bitwise where it is
     torch's driver, else within LINALG_EPS_FACTOR n eps ||A||; both
     timed); the Jacobi SVD kernel (csrc/jacobi_svd.cu) at every taxi
     unfolding in float32 and float64 against torch.linalg.svd in float64
     (JACOBI_LIMITS s_max on singular values, reconstruction and vectors
     over their gap, orthonormal within sqrt(k) eps more; short of its cap
     of sweeps), its launches a call (each of JACOBI_KERNELS once, by the
     library's own launch counts), a captured call replayed twice bitwise, timed beside
     its bound and torch.linalg.svd, and its plain version on the same
     inputs in the CPU pool, held the same way and to the kernel's singular
     values when it returns ("9 checks", after phase 25); the kernel's
     sweeps on the spectra its cap was read from (tools/jacobi_sweeps:
     graded, clustered, rank-deficient at the taxi tall forms, normal
     5000 x 1000 and 5000 x 1024; each converged, within JACOBI_LIMITS of
     torch.linalg.svd in float64); then the SVT
     baselines (ttnn, ring, fctn) through run_method at the full taxi shape,
     10% missing, svd, gram and warm:8, 100 iterations on the graph route
     of baselines/device_loop.py (the card's default; gram's err_hist
     within rtol 1e-3 of svd's over the first 10 iterations): one capture
     (two with warm:8), one synchronizing call in the loop a segment, the
     binding's calls per driver and the Jacobi kernel's launches counted
     (the svd rows: only the kernel's, none stopped at its cap of sweeps,
     `device_linalg.jacobi_capped`); fctn's gram and warm:8
     (EAGER_BASELINES: its 1000 x 1000 Grams go to Xsyevd, which no graph
     captures) on the eager loop, no capture. The svd and gram rows' final
     RRE within BASELINE_RRE_TOL of the JAX package's float64 gram run's
     (gram's also of the port's), fctn warm:8's within 1e-3 of gram's; at
     10 iterations the graph route, the graph route again and the device
     form without graphs bitwise (fctn gram and warm:8: the eager loop
     twice bitwise, the device form within rtol 1e-4); sofia
     for 10 epochs. Then SOFIA's
     two kernels (csrc/sofia_kernels.cu) against their plain versions at the
     shapes the main path gives them at taxi, highway and network (the
     mode-1 and mode-2 grams and the mode-3 step's inputs, from the
     stand-ins with 10% missing, one mode-1 slice all missing, one observed
     at one entry), float32 and float64: pinv_rows within PINV_EPS_FACTOR r
     eps times each gram's condition of its row's scale, the all-zero
     gram's row exactly zero; mode3_sweep (one launch a call) and, on the
     same systems, the gauss_seidel_sweep kernel within SWEEP_EPS_FACTOR eps of
     their largest value; each timed beside its bound and its plain version
     (the row loop at taxi); pinv_rows also beside torch.linalg.pinv with
     the row product and its one-pass floor (diagonal grams), mode3_sweep
     beside its chain bound (n3 (r + 1) FMA latencies at clocks.max.sm), the
     sweep kernel alone and, at taxi, the split step (the systems in torch,
     then that kernel: card time and host enqueue).
 10. RC-FCTN's video driver at 240x320x300 with its default route (auto:512)
     for 10 iterations, on the graph route and the device form without
     graphs: bitwise, one capture, one synchronizing call in the loop;
     trpca_snn at the taxi stand-in (SNN_ITERS iterations, float32) on the
     graph route and the device form without graphs, bitwise, every SVD the
     Jacobi kernel's, none stopped at its cap, and SNN_F64_ITERS in float64
     on the graph route;
     trpca_tnn on a 64x64x32 slab and rnc_fctn on a 16x16x8x8 problem, 20
     iterations each.
 11. the completion CLI in-process: triple, ttnn, ring and fctn on taxi.
 12. the parallel layer with one rank on NCCL, in this process:
     tritd_admm_sharded on the taxi stand-in (f32, 100 iterations, tol 0,
     origin given) in mode 1 and mode 3, masked taxi with bf16 storage in
     mode 1 and the highway video (240x320x300) in mode 3, each on the CUDA
     graph route that NCCL allows (one replay a block of cfg.unroll
     iterations, the four all_reduce calls of an iteration inside it, the
     penalties and the counter on the card) and on the eager loop
     (`_local_solve`'s `_eager`), in turns graph, eager, eager, graph: final
     A, B, C, O, E, err_hist and rre_hist bitwise equal between the routes;
     one kernel launch per iteration, all through the pointer entry on the
     graph route; 4 all_reduce calls per iteration on both routes, their
     words within the design budget; max_iter + 1 synchronizing calls in a
     graph-route loop (one iteration a step, whatever cfg.unroll, as the
     reference's sharded loop); err_hist and rre_hist within
     rtol 1e-6 of tritd_admm on the same data and init. Prints CUDA-event ms per
     iteration of each route, the graph route's time to its first replay
     and its replays' ms per iteration, and the peak MiB of each. The first
     graph run of each case is the main path: its launches join the
     kernels line.
 13. several ranks on the one card, as worker processes of
     tritd_tpu_torch.parallel.distributed with --backend gloo --device
     cuda:0, at full width: taxi in mode 1 at 2, 3 (n1 padded to 102) and 4
     ranks, masked taxi with bf16 storage at 2 ranks, the video stand-in in
     mode 3 at 4 ranks. Each is held to the single-process solve on the same
     data (err_hist, rre_hist: rtol 2e-3, atol 1e-5; rtol 2e-2, atol 1e-4
     with bf16 storage; atol 2e-4 where the video's err_hist nears its
     float32 floor, below 4e-3; n_iters equal; the workers run RANKS_ITERS
     iterations, tol 0, once: a depth cut from 100 and no second timed
     run, since the ranks share the card); every rank must have launched its
     kernel variant once per iteration, and the replicated factors must
     agree across ranks.
 14. DP x TP: four ranks as a 2x2 mesh, a batch of two taxi problems from
     two seeds through tritd_admm_batch_sharded (each data group's entry in
     the batched loop: the batched entry once an iteration), each entry
     held to its own single-process solve as in phase 13.
 15. the functional Tensor Toolbox surface (tritd_tpu_torch.ops: kruskal,
     decomp, tenutils, sparse, symmetric, cp_variants) on the card in
     float32, every result checked to lie on the card, each call timed with
     CUDA events after one warm-up and held to the same call on the CPU in
     float64 on the same numpy inputs: dense at the taxi stand-in's
     100x100x500 (mttkrp, ktensor_full, cp_als, tucker_hosvd/hooi, nvecs,
     ttm/ttv/ttt, the Kruskal and Tucker norms, cp_nmu, cp_arls); sparse on
     the entries a taxi completion problem observes, 10% and 90% kept, as
     COO (sp_full, both branches of sp_norm, sp_innerprod, sp_ttv, sp_mttkrp
     also against the dense mttkrp and beside torch.sparse.mm, cp_als_sparse
     also against cp_als on the zero-filled tensor); symmetric at order 4,
     n = 40 (symmetrize, ttsv, eig_sshopm, eig_geap with teneye(4, 40),
     eig_sshopmc, tucker_sym, cp_sym: eigen-residuals under 1e-3); the
     optimisers at 60x70x80, R = 5 (cp_opt, cp_wopt, gcp_opt with three
     losses: the final loss within 5% of the CPU run's). It launches no
     kernel of this package: einsum/matmul, torch.linalg, index_add_ and
     autograd, as the reference leaves these to its compiler.
 16. the nine Tensor Toolbox classes (tritd_tpu_torch.ops.classes) on the
     card in float32 by phase 15's rule (results on the card, one warm-up,
     CUDA events, held to the same call on the CPU in float64): Tensor at
     100x100x500 (ttm, ttv, mttkrps, nvecs, norm, innerprod with a Tensor,
     KTensor, TTensor, SpTensor and SumTensor, the to_tenmat round trip,
     collapse, scale); SpTensor on the 499 421 entries phase 15 keeps of taxi
     (full, mttkrp by mode, ttv, ttm, innerprod, the to_sptenmat round trip,
     norm); KTensor R = 10 and TTensor with a 5x5x5 core (full, norm,
     innerprod, nvecs, normalize/arrange); SymTensor and SymKTensor at order
     4, n = 40 (full, norm, fg with its gradient, also against
     torch.autograd on the card); SumTensor of a dense, a Kruskal and a
     sparse part (innerprod, mttkrp, ttv). Then cp_opt in float32 from its
     default 0.1-normal init must leave the saddle (loss below 0.1 after 30
     L-BFGS iterations), and toolbox_audit --check must count 249
     implemented, 31 n/a and no problem. No kernel of this package.
 17. emulator parity in float64 on the card (tritd_tpu_torch.tools.
     emulator_parity): triple at the full taxi width, 30 iterations (the
     emulator takes most of a second an iteration on the host), then all
     five methods at the sensor shape (54x4x1440) at their protocol depth,
     100 iterations or epochs; the emulator sides run in worker processes
     beside the port sides. Each row is printed as JSON; each must meet its
     PASS_BAR (1e-5, sofia 1e-4, on max |err_hist difference|) with equal
     iteration counts, and every row, being float64, must also stay within
     1e-10 of the emulator, the bar of the CPU tests, so that a solve at a
     lower precision fails; triple must launch the f64 T' kernel variant
     once per iteration. Its launches join the kernels line.

 18. the scaling model (tritd_tpu_torch.tools.scaling_model) on phase 3's
     one-card ms per iteration at taxi and video and the all_reduce calls
     and bytes phase 12 counted; prints its JSON line; every multi-GPU
     figure in it is predicted.
 19. numpy input at the full taxi width (100x100x500, float32): tt_trpca,
     rtrc and rc_fctn_driver_traffic (gram, 10 iterations), trpca_tnn (2),
     sofia_init (2 epochs), sofia_stream_device (its batch init 2 epochs)
     and rnc_fctn on phase 10's 16x16x8x8 problem (20), each called from
     numpy and again on CUDA tensors of the same values: every result on
     the card, each equal to the tensor call's bitwise (or, where it is
     not, within rtol 1e-6 and atol 1e-6 max|input|, the reason printed).
     Then tritd_admm_auto on a one-rank NCCL mesh like phase 12's, taxi, 100
     iterations, tol 0, from numpy: bitwise phase 12's mode-1
     tritd_admm_sharded result, one kernel launch per iteration (its
     launches join the kernels line).
 20. the reference-shaped ops.elementwise_block (six outputs, compute_dtype
     and store_dtype) at the taxi shape: float32, float64, bf16 storage at
     float32 compute (one launch of the variant the dtypes name) and a mix
     of bf16 and float32 inputs into float16 stores (cast to float32, one
     launch of the pure variant, the stores rounded), each held to the
     plain version at phase 2's tolerances; then every entry point of
     tests/torch_numpy_entries.py (the metrics, the functional ops surface,
     prox_tnn, the flat block, interop's six *_from_numpy, sofia_stream)
     from numpy and again on CUDA tensors of the same values: every result
     on the card (sofia_stream's batch init), equal to the tensor call's
     bitwise or within phase 19's tolerance; init_factors on the card by
     default, bitwise the CPU draw. These launches are checks, not the
     main path, and stay out of the kernels line.
 21. the two routes of the solve loop (solvers/admm.py): taxi f32, taxi
     bf16 storage, masked taxi f32 and highway f32, 100 iterations, tol 0,
     each on the CUDA graph route that tritd_admm takes (one replay a block
     of cfg.unroll iterations, the penalties and the counter on the card)
     and on the eager loop (run_admm's _eager), in turns graph, eager,
     eager, graph: the final factors, O, E and err_hist bitwise equal; CUDA
     event ms per iteration of each route, the synchronizing calls in each
     solve (torch.cuda.set_sync_debug_mode: the graph route must make
     ceil(max_iter / unroll) + 1, the stop flag before each block and the
     penalties once), and the peak MiB of each; for the graph route also
     the events' ms up to its first replay (the eager first block and the
     captures, with the captures' host ms) and its ms per iteration from
     there. Its launches are checks and stay out of the kernels line.
 22. a batch's entries in one loop (tritd_admm_batch_sharded, the
     reference's vmapped while_loop) on a one-rank NCCL mesh: the four CDnet
     video stand-ins (highway, sofa, office, PETS2006, 240x320x300,
     VIDEO_TRITD, 100 iterations, tol 0; the reference's configuration 5)
     in f32 and with bf16 storage, the four traffic stand-ins (sensor,
     network, taxi, chicago, 10% missing, zero-padded to 100x100x2016,
     COMPLETION_TRITD; the reference's batched completion row) at tol 0,
     and the same with a tol, found from those tol-0 histories, under which
     two entries stop early at different iterations; and the video batch in
     float64 for 10 iterations, a second witness that the batched route
     computes the serial one's function: every field, L included, within
     1e-10 of the serial route's relative to its largest value. Each on the batched
     graph route and `_serial=True` (each entry's own sharded solve), in
     turns batched, serial, serial, batched: n_iters equal, each route
     bitwise its second run, each entry's fields bitwise the serial route's
     (the count printed) or its histories within the reference's float32
     sharded tolerances and L and O within rtol 2e-2; one batched launch an
     iteration and no single one; one synchronizing call before each
     iteration and one at the end (max_iter + 1 at tol 0); 4 all_reduce
     calls an iteration carrying every entry's words; ms per iteration of
     the whole batch, time to the first replay, replays' ms per iteration
     and peak MiB of each route; RRE of each entry against its stand-in.
     The first batched run of each case is the main path: its launches
     are the kernels line's batch_launches.
 23. the other solve loops on their graph route against their eager loops:
     tritd_admm_checkpointed at taxi f32 (every=25, 50 iterations, tol 0;
     one graph run and one eager run (`checkpointed._solve(...,
     graphs=None)`), each with its two saves,
     about 8 s each): bitwise A, B, C, O, E and the histories, the same
     checkpoint files, two captures for the call, max_iter + one
     synchronizing call a segment (the saves' reads left out), one launch
     an iteration through the pointer entry; ms per iteration of each route
     with the saves timed apart (events), the time to the first replay.
     tritd_admm_outlier at highway, tritd_als and tritd_mals at taxi, 100
     iterations (tol 0; MALS has no stop), in turns graph, eager, eager,
     graph: bitwise, captures (outlier 2, ALS and MALS 1), synchronizing
     calls (outlier and ALS one a flag read after each iteration short of
     max_iter and one at the end, MALS 1), ms per iteration of each route,
     peak MiB. Then solve_method "pinv" and "lstsq" at taxi (3
     iterations) through tritd_admm and, on one NCCL rank,
     tritd_admm_sharded and tritd_admm_batch_sharded (taxi and its mirror
     image): the eager loop on the card, no capture, the kernel through
     its by-value entry (the batched one once an iteration), finite
     histories, the route printed. These launches are checks and stay out
     of the kernels line.
 24. SOFIA's three device loops, the reference's ALS and epoch
     while_loops and its stream scan: first the main path, sofia_init at
     taxi (SOFIA_PRESET, 10 epochs, float32) and in float64 (2 epochs) on
     the CUDA graph route, whose launches of the two kernels are the
     kernels line's (two pinv_rows and one mode3_sweep an ALS iteration;
     no gauss_seidel_sweep, `_mode3_systems` or torch.roll call on it);
     then sofia_init at taxi (10 epochs) and highway (2
     epochs, a depth cut) on the graph route and without graphs, in turns
     graph, eager, eager, graph: factors, X, O and err_hist bitwise, at
     most SOFIA_CAPTURES captures a call, the synchronizing calls, ms an
     epoch (events); the ALS loop alone (taxi, 20 iterations, tol 0), ms an
     iteration, one mode3_sweep launch an iteration; sofia_init at taxi at
     r = 4 (2 epochs), graph route against the route without graphs, in
     turns, bitwise; sofia_stream_device at taxi on both routes (4 runs),
     bitwise, ms a frame (events around the scan); then taxi's float32
     sofia_init on the card against float64 on the CPU (err_hist rtol
     1e-3), the mode-3 step (rtol 1e-3, atol 1e-4) and a 100x100 stream (rtol
     1e-3, atol 1e-3 max|X|) likewise.
 25. The Tensor Toolbox's ten solver loops (ops/toolbox_loop.py) at phase
     15's sizes in float32, tol 0: cp_als, cp_nmu, cp_apr (5 outer
     iterations of 10 inner sweeps) and cp_arls at taxi, R = 10 (cp_nmu
     and cp_apr on taxi's rounded absolute values), cp_als_sparse on taxi's
     COO at 10% and 90%, eig_sshopm, eig_sshopmc and eig_geap (B =
     teneye) on a 40^4 symmetric tensor, gcp_opt ("count") at
     TOOLBOX_OPT_SHAPE, R = 5, cp_sym at 40^4, rank 3, and tucker_hooi at
     taxi, ranks 5, 5, 5 (its eigh through ops/device_linalg.py, whose calls
     it must make); each on the
     graph route (the default on the card), the device form without graphs
     and the host loop, in turns graph, no graphs, host loop, graph:
     bitwise (cp_als_sparse, whose scatter-adds are atomic, within
     TOOLBOX_SPARSE_ROUTE_TOL), one capture a graph-route call, the
     synchronizing calls (a flag read after each iteration short of
     max_iters and the counter at the end; cp_arls one more, its draws'
     copy to the card), ms an iteration of each route (events), the graph
     route's time to its first replay and its replays' ms an iteration,
     peak MiB above what was allocated at the call's start; each held to
     the same call in float64 on the CPU (in the worker processes of phase
     3's pool, queued after phase 3's own).
 26. (run right after phase 10) The Jacobi SVD on exactly rank-deficient
     matrices (tools/jacobi_sweeps.EXACT_SMALL: an integer outer product
     and its transpose, static clips, rank 3 from duplicated columns, zero
     columns), float32 and float64: each converged within LAPACK's 30
     sweeps, jacobi_capped 0, held to torch.linalg.svd in float64
     (JACOBI_LIMITS) and to its plain version on the CPU (the same values
     zero); each eager jacobi_svd returns. The same for zero columns
     among standard normal ones at the video cut's tall forms 96000 x 240
     and 76800 x 300, float32 (the plain version on the card), its
     readings and sweeps printed. The kernel at the video cut's
     unfoldings (240 x 320 x 300: 240 x 96000,
     76800 x 300, 96000 x 240) of the highway stand-in and of its static
     clip (frame 0 repeated 300 times, made here), float32: its plan at
     m = 76800 and 96000, sweeps, ms a call against torch.linalg.svd
     (gesvdj), held to torch.linalg.svd in float64. Then the video
     protocol's ttnn and ring on the CLIs' default svd route
     (`cli/run_video.solve`, the video presets, nothing missing, float32)
     on both clips, cut to VIDEO_SVD_ITERS iterations: the graph route, one
     capture, no synchronizing call in the loop but the segment's read,
     every SVD the Jacobi kernel's (no binding call), jacobi_capped 0, ms
     an iteration; X, the RRE and err_hist held to the port's float64 run
     of the same iterations on the CPU (phase 3's pool; ring's freedom
     ratio the card run's, from the float32 data) with relative limits
     (VIDEO_SVD_X_RTOL; VIDEO_SVD_RTOL and VIDEO_SVD_ATOL, float32's
     rounding of an RRE), held after phase 25 ("26 checks"). Its svd
     rows' Jacobi launches join the kernels line's.

The ranks of phases 13-14 share one card and are time-sliced: the seconds
they print are not scaling numbers.

Phases 8-11, 15, 16 and 25 launch no kernel of this package but the one inside `triple`
and SOFIA's two: the baselines' eigh and SVD are cuSOLVER through
ops/device_linalg.py on the card (its `info` left unread, as the reference's
XLA calls leave it), their QR, FFT and GEMMs torch.linalg, torch.fft and
torch.matmul, as the reference leaves them to its compiler. The binding's
calls per driver are printed on phase 9, 10 and 25's lines, not on the
kernels line.

Each solve counts the kernel's launches from zero and must launch its
variant once per iteration (in phases 13-14 every rank counts its own). On
the graph route the wrapper counts the first block's launches, which run
eagerly, and each replay of a graph counts its kernel nodes: a capture
launches nothing and counts nothing. Every launch of phase 3's solves
must go through the pointer entry. The line before the last is a JSON
object with one record per kernel variant, all 82 on the main path (the
launches of phases 3, 5, 12, 17 and 19; pointer_launches, those of them
through the pointer entry; batch_launches, phase 22's through the batched
entry; batch_ms, batch_pointer_ms and batch_bound_ms, phase 2's batched
timings at 4 x taxi), each naming the .cu file that holds its entry
point, then SOFIA's two kernels of the main path, pinv_rows and
mode3_sweep, in float32 and float64 (phase 9's taxi records, with
pinv_rows' floor_ms and mode3_sweep's sweep_kernel_ms and split_step_ms,
all measured in the run; phase 24's main-path launches; the chain bound,
an assumed FMA latency over the clock, stays on phase 9's own lines), then
the Jacobi SVD in float32 and float64 (phase 9's 5000x1000 record, every
taxi unfolding's under "shapes"; the launches of phase 9's svd rows,
phase 10's trpca_snn graph-route runs and phase 26's video svd rows), each naming the reference function
it stands for; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or of the tritd_tpu
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import tritd_tpu_torch  # noqa: E402

if Path(tritd_tpu_torch.__file__).resolve().parent.parent != HERE:
    raise SystemExit(f"tritd_tpu_torch must come from {HERE}, got {tritd_tpu_torch.__file__}")

from tritd_tpu_torch.data import load_dataset, uniform_missing_mask  # noqa: E402
from tritd_tpu_torch.metrics.recon import rre  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.device_linalg import JACOBI_LIMITS, LAPACK_SWEEPS  # noqa: E402
from tritd_tpu_torch.ops.designs import triple_product  # noqa: E402
from tritd_tpu_torch.ops.narrow import narrow_cast  # noqa: E402
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    OutlierConfig,
    TriTDConfig,
    init_factors,
    init_state,
    run_admm,
    trim_history,
    tritd_admm,
    tritd_admm_checkpointed,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)
from tritd_tpu_torch.solvers.admm import t_dtype_of  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, README_MISSING_RATIO, SOFIA_PRESET, VIDEO_TRITD  # noqa: E402

KERNEL_SHAPES = {
    "taxi": (100, 100, 500),
    "video": (240, 320, 300),
    "ragged": (17, 23, 31),
    "one": (1, 1, 1),
    # the slabs the sharded solves hold on a rank: taxi over 2, 3 (102 rows)
    # and 4 ranks along mode 1, video over 4 ranks along mode 3
    "slab2": (50, 100, 500),
    "slab3": (34, 100, 500),
    "slab4": (25, 100, 500),
    "frames4": (240, 320, 75),
}
# narrow variants: (compute, D, storage, T') dtypes; T' None = no T' (masked
# storage: D in the compute dtype)
NARROW = {
    variant: (cd, d_dt, s_dt, None if (d_dt == cd and s_dt != cd) else t_dt)
    for (cd, d_dt, s_dt, t_dt), variant in hopper_kernels.KERNEL_VARIANTS.items()
    if variant not in ("f32", "f64")
}
F16, E4M3, E5M2, BF16 = "float16", "float8_e4m3fn", "float8_e5m2", "bfloat16"
F32, F64 = "float32", "float64"
# The variants that store or form T' in float32 or float64 beside the other
# compute dtype, or T' in the compute dtype beside other storage (since PR
# 11): their coverage solves are the shortest.
WIDE = {variant for variant, (cd, _d, s_dt, t_dt) in NARROW.items()
        if t_dt in (torch.float32, torch.float64) or s_dt in (torch.float32, torch.float64) and s_dt != cd}
# The narrow solves of phase 3 beside the bf16 ones, at full width: (data,
# TriTDConfig fields, iterations, expected outcome). "nan": taxi reaches
# 526.1, past float8_e4m3fn's range, which the reference's rounding makes
# NaN. Then, cut to COVERAGE_ITERS, one solve for each variant that no run
# before it launched on finite data: on highway (largest value 273.6) for a
# variant that rounds to float8_e4m3fn, else on taxi.
NARROW_SOLVES = [
    ("taxi", {"storage_dtype": F16}, 100, None),
    ("taxi", {"einsum_dtype": F16}, 100, None),
    ("taxi", {"storage_dtype": F16, "masked": True}, 100, None),
    ("taxi", {"storage_dtype": E5M2}, 100, None),
    ("video", {"storage_dtype": F16}, 100, None),
    ("video", {"storage_dtype": E5M2}, 100, None),
    ("video", {"storage_dtype": E4M3}, 100, None),
    ("taxi", {"einsum_dtype": E4M3}, 100, "nan"),
    ("taxi", {"einsum_dtype": E5M2}, 100, None),
    ("taxi", {"storage_dtype": F16, "einsum_dtype": BF16}, 100, None),
    ("taxi", {"storage_dtype": BF16, "einsum_dtype": E4M3}, 100, "nan"),
    ("taxi", {"storage_dtype": E4M3}, 100, "nan"),
    ("taxi", {"storage_dtype": F16, "dtype": "float64"}, 20, None),
    ("taxi", {"storage_dtype": E5M2, "dtype": "float64"}, 20, None),
    ("video", {"storage_dtype": E4M3, "dtype": "float64"}, 20, None),
    # the reference's float32/float64 cases (since PR 11): float32 storage or
    # einsum at float32, float64 storage at float32 (also masked), float64
    # einsum at float64, float32 storage at float64, and the last on highway
    ("taxi", {"storage_dtype": F32}, 100, None),
    ("taxi", {"einsum_dtype": F32}, 100, None),
    ("taxi", {"storage_dtype": F64}, 100, None),
    ("taxi", {"storage_dtype": F64, "masked": True}, 100, None),
    ("taxi", {"einsum_dtype": F64, "dtype": F64}, 100, None),
    ("taxi", {"storage_dtype": F32, "dtype": F64}, 100, None),
    ("video", {"storage_dtype": F32, "dtype": F64}, 20, None),
]
# Iterations of the coverage solves: highway's CPU solve costs 4.6 times
# taxi's, and a float8 einsum on highway diverges within three. The WIDE
# variants' coverage solves are cut further, to keep the script's time.
COVERAGE_ITERS = {"taxi": 10, "video": 4}
WIDE_COVERAGE_ITERS = {"taxi": 4, "video": 2}
# The first 10 err_hist entries of each narrow solve (all of a shorter one)
# are held to the same solve on the CPU in the same dtypes, where both are
# finite and the CPU's has not risen above its first entry (a float8 einsum
# on highway passes its format's range within a few iterations). Where only
# D and the state are rounded, once each, the runs agree within
# NO_FEEDBACK_RTOL at every entry. A narrow value that feeds back into the
# factor solves (the einsum dtype rounds the factors in every mode solve;
# masked mode imputes D from the stored O) lets the summation order of
# cuBLAS against the CPU's BLAS flip some of those roundings, and the runs
# part by more at each iteration: FEEDBACK_RTOL over the first
# TIGHT_ENTRIES entries, and after them FEEDBACK_RTOL again, or
# FLOAT8_FEEDBACK_RTOL when a float8 dtype is in the run. Each limit is
# three to eight times the largest distance read on an NVIDIA H100 80GB
# HBM3 at 700 W (1.3e-4 without feedback; 2.8e-3 over the first four
# entries with it; after them 3.2e-3 for 2-byte dtypes and 3.6e-2 with a
# float8 one; `PERF.md` §6).
# A control (`_t_rounded_toward_zero`) plants a fault in the CPU run of the
# first solve of each kind that holds TIGHT_ENTRIES entries, and for a
# float8 T the smoke fails unless the fault moves them past the limit.
TIGHT_ENTRIES = 4
NO_FEEDBACK_RTOL = 1e-3
FEEDBACK_RTOL = 1e-2
FLOAT8_FEEDBACK_RTOL = 0.1


def _variant_of(fields: dict) -> str:
    """The kernel variant a solve with these TriTDConfig fields launches."""
    cfg = TriTDConfig(**fields)
    cd, sd, ed = cfg.torch_dtype(), cfg.torch_storage_dtype(), cfg.torch_einsum_dtype()
    if cfg.masked:  # D imputed in the compute dtype, no T'
        return hopper_kernels.KERNEL_VARIANTS[(cd, cd, sd, sd)]
    return hopper_kernels.KERNEL_VARIANTS[(cd, sd, sd, ed or sd)]


def _fields_of(variant: str) -> dict:
    """TriTDConfig fields of a solve that launches `variant`."""
    (cd, d_dt, s_dt, t_dt), = (k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    name = lambda dt: str(dt).removeprefix("torch.")  # noqa: E731
    fields = {"dtype": name(cd)}
    if d_dt == cd and s_dt != cd:
        fields.update(storage_dtype=name(s_dt), masked=True)
    elif s_dt == cd:
        fields.update(einsum_dtype=name(t_dt))
    else:
        fields.update(storage_dtype=name(s_dt), **({} if t_dt == s_dt else {"einsum_dtype": name(t_dt)}))
    return fields


def _short(name: str) -> str:
    return {"float16": "f16", "float8_e4m3fn": "e4m3fn", "float8_e5m2": "e5m2", "bfloat16": "bf16",
            "float64": "f64", "float32": "f32"}.get(name, name)


# the card's name and power limit (phase 0), and the one-card rows phase 18
# feeds the scaling model (phases 3 and 12)
CARD = [""]
T1_ROWS: list = []
SCALARS = (0.5, 0.7, 1.8)  # mu_l, mu_o, lam
MU_NEXT = 0.625
REPS = 4  # timing turns of phase 2's variants, their median taken (kept short: the smoke's time limit)
LINALG_REPS = 5
BATCH = 10
SLEEP_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep cycles a second, at or above the H100's SM clock
RRE_FAMILY = 0.03  # bf16 vs f32 RRE bound of the reference's own test
# The card's published peaks (H100 SXM data sheet): device memory rate, the
# float32 rate outside the tensor cores and the float64 rate through them
# (DMMA; 34 TFLOP/s outside them): the card's peak for each type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# Arithmetic of the block per element: r1 3, r2 2, o 4, the shrink 5, the
# two residuals 3, the duals 4, the two sums of squares 4, T' 3.
BLOCK_FLOPS_PER_ELEMENT = 28


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    CARD[0] = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase1() -> None:
    t0 = time.perf_counter()
    path = build.build()
    kernels.library()
    print(f"phase1 build: {path.name} in {time.perf_counter() - t0:.2f} s")


def _time_pair(plain, kernel_calls: dict, n_bytes, reps: int = REPS) -> tuple[dict, float, float, dict]:
    """ms per call of each of `kernel_calls` (name -> call), of the plain
    version and of one device-to-device `copy_` that moves `n_bytes` (half
    read, half written): CUDA events around BATCH back-to-back calls,
    median over REPS turns, the order of the plain version and the kernels
    turning round each turn. Before each batch of the kernel and the copy
    the card sleeps for longer than the host takes to enqueue it
    (torch.cuda._sleep), so that the events hold the card's time alone, not
    the wait for the first call; the plain version, whose host time is
    about its device time, is timed without (a sleep would double phase 2).
    Also each kernel call's enqueue time in ms: the host's clock around the
    same BATCH calls, before the synchronize (what a call costs the host,
    whatever the card does). Without `plain` (None) only the kernel calls
    and the copy are timed, and the plain time is None; `reps` turns."""
    src = torch.empty(n_bytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    calls = [*([("plain", plain)] if plain else []), *kernel_calls.items(), ("copy", lambda: dst.copy_(src))]
    enqueue = {}
    for _ in range(3):
        for name, fn in calls:
            t0 = time.perf_counter()
            fn()
            enqueue[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
    times = {name: [] for name, _fn in calls}
    host = {name: [] for name in kernel_calls}
    timed = calls[:-1]
    for i in range(reps):
        turn = timed[i % len(timed):] + timed[:i % len(timed)]
        for name, fn in (*turn, calls[-1]):
            if name != "plain":
                torch.cuda._sleep(int(1.25 * BATCH * enqueue[name] * SLEEP_CYCLES_PER_S))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(BATCH):
                fn()
            spent = time.perf_counter() - t0
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / BATCH)
            if name in host:
                host[name].append(spent / BATCH * 1e3)
    return ({name: statistics.median(times[name]) for name in kernel_calls},
            statistics.median(times["plain"]) if plain else None,
            statistics.median(times["copy"]), {name: statistics.median(v) for name, v in host.items()})


def _block_bytes(args, t_dtype) -> int:
    """Bytes the block must move: its five inputs, four outputs in the
    storage dtype, and T' when built."""
    d, l, e = args[0], args[1], args[2]
    per = d.element_size() + l.element_size() + 3 * e.element_size() + 4 * e.element_size()
    if t_dtype is not None:
        per += torch.empty((), dtype=t_dtype).element_size()
    return per * d.numel()


def _block_bound(args, t_dtype) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    one call of the block on these tensors, the larger of its bytes over the
    memory rate and its arithmetic over the compute dtype's peak rate."""
    by_bytes = _block_bytes(args, t_dtype) / PEAK_BYTES_PER_S * 1e3
    by_ops = BLOCK_FLOPS_PER_ELEMENT * args[0].numel() / PEAK_FLOPS[args[1].dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _report(tag, args, t_dtype, max_abs, plain, kw, pointer: bool) -> dict:
    """Time the kernel, with `kw` (mu_l_next, t_dtype), against the plain
    version; print one line and return the variant's record. With `pointer`
    (the shape of the kernels line's records) through both entries: `ms` is
    the pointer entry's, the form that the solve's CUDA graph launches (the
    penalties as 0-d tensors on the card), and `by_value_ms` the by-value
    entry's, which the eager routes launch; else through the by-value entry
    alone. No single PyTorch call computes the block, so `library_ms` is
    null; `copy_ms` is the rate the card really gives a pass that reads and
    writes in equal parts, a yardstick the port never calls."""
    n_bytes = _block_bytes(args, t_dtype)
    calls = {"by_value": lambda: hopper_kernels._block_cuda(*args, *SCALARS, **kw)}
    if pointer:
        mu_l, mu_o, mu_n = (torch.tensor(x, dtype=args[1].dtype, device="cuda")
                            for x in (SCALARS[0], SCALARS[1], kw["mu_l_next"] or 1.0))
        pointer_kw = dict(kw, mu_l_next=None if kw["mu_l_next"] is None else mu_n)
        calls["pointer"] = lambda: hopper_kernels._block_cuda(*args, mu_l, mu_o, SCALARS[2], **pointer_kw)
    ms, plain_ms, copy_ms, host_ms = _time_pair(plain, calls, n_bytes)
    form = "pointer" if pointer else "by_value"
    bound_ms, bound_by = _block_bound(args, t_dtype)
    also = (f"by_value={ms['by_value'] * 1e3:9.1f} us " if pointer else "") + \
        f"host_enqueue={host_ms[form] * 1e3:6.1f}" + (f" / {host_ms['by_value'] * 1e3:6.1f}" if pointer else "")
    print(f"phase2 {tag} max_abs_err={max_abs:.3e} kernel={ms[form] * 1e3:9.1f} us "
          f"({n_bytes / ms[form] / 1e6:7.1f} GB/s) {also} us "
          f"plain={plain_ms * 1e3:9.1f} us ({n_bytes / plain_ms / 1e6:7.1f} GB/s) copy_us={copy_ms * 1e3:7.1f} "
          f"({n_bytes / copy_ms / 1e6:7.1f} GB/s) bytes/elem={n_bytes // args[0].numel()} "
          f"bound={bound_ms * 1e3:.1f} us by {bound_by} ({bound_ms / ms[form]:.0%} reached"
          + (f"; by value {bound_ms / ms['by_value']:.0%})" if pointer else ")"))
    return {"max_abs_err": max_abs, "ms": ms[form], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "by_value_ms": ms["by_value"], "copy_ms": copy_ms,
            "host_enqueue_ms": host_ms[form], "by_value_host_enqueue_ms": host_ms["by_value"]}


# calls of a variant's pointer entry held bitwise to its by-value entry
POINTER_HELD: dict = {}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _hold_pointer_entry(args, got, mu_next, t_dtype=None) -> None:
    """The same call through the variant's pointer entry, the penalties as
    0-d tensors on the card: every store and both sums bitwise `got`, the
    by-value entry's outputs."""
    cd = args[1].dtype
    mu_l, mu_o, mu_n = (torch.tensor(x, dtype=cd, device="cuda") for x in (SCALARS[0], SCALARS[1], mu_next or 1.0))
    ptr = hopper_kernels._block_cuda(*args, mu_l, mu_o, SCALARS[2], None if mu_next is None else mu_n,
                                     t_dtype=t_dtype)
    torch.cuda.synchronize()
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    wrong = [names[i] for i in range(7) if (got[i] is None) != (ptr[i] is None)
             or got[i] is not None and not _same_bits(got[i], ptr[i])]
    variant = hopper_kernels.kernel_variant(*args, t_dtype=t_dtype if mu_next is not None else None)
    if wrong:
        raise AssertionError(f"{variant}: the pointer entry's {wrong} differ from the by-value entry's bits")
    POINTER_HELD[variant] = POINTER_HELD.get(variant, 0) + 1


def _hold_same_dtype(args, mu_next) -> tuple[tuple, float]:
    """One kernel call on same-dtype tensors held against the plain version
    at phase 2's tolerances, and through the pointer entry bitwise; returns
    the kernel's outputs and the largest absolute difference."""
    atol = 1e-6 * max(float(a.abs().max()) for a in args)
    got = hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=mu_next)
    _hold_pointer_entry(args, got, mu_next)
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next)
    torch.cuda.synchronize()
    idx = (0, 1, 2, 3) if mu_next is None else (0, 1, 2, 3, 6)
    for i in idx:
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=atol)
    for i in (4, 5):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
    return got, max(float((got[i] - want[i]).abs().max()) for i in idx)


def _narrow_args(shape, dtypes, seed, offset=0) -> list:
    """Five inputs of a narrow variant; with `offset`, each is a view that
    starts that many elements into its buffer."""
    cd, d_dt, s_dt, _ = dtypes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    raw = [torch.randn(n + offset, generator=gen, device="cuda") * 3 for _ in range(5)]
    return [narrow_cast(x, dt)[offset:].view(shape) for x, dt in zip(raw, (d_dt, cd, s_dt, s_dt, s_dt))]


# The batched entry (`elementwise_block_batch`): held bitwise to its pointer
# entry launched on each entry alone at BATCH_HELD entries of these shapes
# (taxi; ragged: n * itemsize no multiple of 16, so that entries 1 and 2 take
# the one-element path where entry 0 takes the vector path, as a launch on
# each alone does where its tensors are views of the batch's; offset: the
# ragged shape with every stream a view that starts so far into its buffer
# that entry 0's addresses are not 16-byte aligned and entry 1's are), and
# timed at BATCH_TIMED entries of taxi against as many pointer launches.
BATCH_HELD = 3
BATCH_HELD_SHAPES = {"taxi": ((100, 100, 500), False), "ragged": ((17, 23, 31), False),
                     "offset": ((17, 23, 31), True)}
BATCH_TIMED = 4
BATCH_REPS = 8
# Phase 22's batches: each variant it launches and the entry shapes it gives
# it (the CDnet stand-ins; the traffic stand-ins padded to one shape). At
# BATCH_TIMED entries of each the batched entry is also held against the
# plain version, `_block_torch(..., batched=True)`, at phase 2's single-entry
# tolerances, and bitwise to per-entry pointer launches, and timed.
BATCH_MAIN_PATH = {"f32": ("video", "traffic"), "c32_dbf16_sbf16_tbf16": ("video",), "f64": ("video",)}
BATCH_SHAPES = {**KERNEL_SHAPES, "traffic": (100, 100, 2016)}


def _release_cached() -> None:
    """Hand the card memory no tensor holds back to the driver: the
    garbage of reference cycles first (a CUDA graph's private pool among
    it), then the caching allocator's free segments. A CUDA graph's pool
    cannot take segments the allocator keeps cached for other tensors:
    without this, phase 22's graphs ran out of memory in a whole smoke
    (not alone) beside 36 GiB reserved and unused after phase 2's and the
    earlier phases' large buffers."""
    gc.collect()
    torch.cuda.empty_cache()


def _batch_mus(cd, nb: int, with_t: bool):
    """(mu_l, mu_o, mu_l_next) of a batch, one penalty an entry, on the card."""
    steps = torch.arange(nb, dtype=torch.float64) * 0.25
    mu_l, mu_o = ((SCALARS[i] * (1 + steps)).to(cd).cuda() for i in (0, 1))
    return mu_l, mu_o, (MU_NEXT * (1 + steps)).to(cd).cuda() if with_t else None


def _offset_like(x: torch.Tensor, offset: int) -> torch.Tensor:
    """An empty tensor like x that starts `offset` elements into its buffer."""
    return torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)[offset:].view(x.shape)


def _batch_offset(shape, key) -> int:
    """Elements to start every stream of a batch of `shape` entries into its
    buffer so that entry 0's addresses are not 16-byte aligned and entry
    1's are."""
    cd, d_dt, s_dt, t_dt = key
    narrowest = min(torch.empty((), dtype=x).element_size() for x in (cd, d_dt, s_dt, t_dt) if x is not None)
    offset = -int(np.prod(shape)) % (16 // narrowest)
    if not offset:
        raise AssertionError(f"{shape}: every entry of a batch shares entry 0's alignment")
    return offset


def _hold_batch_per_entry(tag, args, got, mus, kw, offset=0) -> None:
    """Each entry's stores and both sums of the batched entry's outputs
    `got` bitwise the pointer entry's launch on that entry alone, which
    stores into views of batch-shaped buffers (starting `offset` elements
    into theirs, as the batch's do), so that its pointers sit where the
    batch's do."""
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    mu_l, mu_o, mu_n = mus
    bufs = [None if x is None else _offset_like(x, offset) for x in (*got[:4], got[6])]
    for i in range(args[0].shape[0]):
        one = hopper_kernels._block_cuda(*(a[i] for a in args), mu_l[i], mu_o[i], SCALARS[2],
                                         None if mu_n is None else mu_n[i],
                                         out=[None if b is None else b[i] for b in bufs], **kw)
        wrong = [names[j] for j in range(7) if (got[j] is None) != (one[j] is None)
                 or one[j] is not None and not _same_bits(got[j][i], one[j])]
        if wrong:
            raise AssertionError(f"{tag}: entry {i}'s {wrong} differ from the pointer entry's launch on it alone")


def _hold_batch_against_plain(tag, args, got, mus, key) -> float:
    """The batched entry's outputs `got` against the plain version on the
    same card tensors, `_block_torch(..., batched=True)`, each entry at
    phase 2's single-entry tolerances: same-dtype variants as
    `_hold_same_dtype`, narrow ones by `check_narrow_against_plain`, the
    sums rtol 1e-5. Returns the largest absolute difference."""
    cd, _d_dt, s_dt, t_dt = key
    mu_l, mu_o, mu_n = mus
    want = hopper_kernels._block_torch(*args, mu_l, mu_o, SCALARS[2], mu_l_next=mu_n, compute_dtype=cd,
                                       store_dtype=s_dt, t_dtype=t_dt if mu_n is not None else None, batched=True)
    torch.cuda.synchronize()
    idx = (0, 1, 2, 3) if mu_n is None else (0, 1, 2, 3, 6)
    same_dtype = all(a.dtype == cd for a in args) and (mu_n is None or t_dt == cd)
    max_abs = 0.0
    for i in range(args[0].shape[0]):
        entry_args = [a[i] for a in args]
        g, w = ([None if x is None else x[i] for x in r] for r in (got, want))
        if same_dtype:
            atol = 1e-6 * max(float(a.abs().max()) for a in entry_args)
            for j in idx:
                torch.testing.assert_close(g[j], w[j], rtol=1e-6, atol=atol, msg=lambda m: f"{tag} entry {i}: {m}")
            max_abs = max(max_abs, *(float((g[j] - w[j]).abs().max()) for j in idx))
        else:
            agree = hopper_kernels.check_narrow_against_plain(entry_args, g, w,
                                                              None if mu_n is None else float(mu_n[i]))
            max_abs = max(max_abs, agree["max_abs_err"])
    for j in (4, 5):
        torch.testing.assert_close(got[j], want[j], rtol=1e-5, atol=0.0, msg=lambda m: f"{tag} sums: {m}")
    return max_abs


def _phase2_batch(records: dict) -> None:
    """Every variant's batched entry: each entry's stores and both sums
    bitwise the pointer entry's launch on that entry alone, at BATCH_HELD
    entries of each of BATCH_HELD_SHAPES; then timed at BATCH_TIMED x taxi
    against BATCH_TIMED pointer launches, the card asleep while the host
    enqueues, beside the bound of the whole batch. The variants and shapes
    of phase 22 (BATCH_MAIN_PATH) are held at BATCH_TIMED entries against
    the plain version and per-entry pointer launches too, and timed. Adds
    `batch_ms`, `batch_pointer_ms` and `batch_bound_ms` (taxi) to each
    variant's record."""
    held = 0
    for seed, (key, variant) in enumerate(hopper_kernels.KERNEL_VARIANTS.items(), start=500):
        cd, d_dt, s_dt, t_dt = key
        with_t = d_dt == s_dt  # masked variants (D in the compute dtype beside other storage) build no T'
        kw = dict(t_dtype=t_dt if with_t else None)
        for shape_name, (shape, offset) in BATCH_HELD_SHAPES.items():
            off = _batch_offset(shape, (cd, d_dt, s_dt, t_dt if with_t else None)) if offset else 0
            args = _narrow_args((BATCH_HELD, *shape), key, seed, off)
            mus = _batch_mus(cd, BATCH_HELD, with_t)
            outs = [_offset_like(args[2], off) for _ in range(4)]
            outs.append(_offset_like(torch.empty(args[0].shape, dtype=t_dt, device="cuda"), off) if with_t else None)
            got = hopper_kernels.elementwise_block_batch(*args, *mus[:2], SCALARS[2], mu_l_next=mus[2], out=outs,
                                                         **kw)
            _hold_batch_per_entry(f"{variant} batched entry at {BATCH_HELD}x{shape_name}", args, got, mus, kw, off)
            held += BATCH_HELD
        for shape_name in ("taxi", *BATCH_MAIN_PATH.get(variant, ())):
            args = _narrow_args((BATCH_TIMED, *BATCH_SHAPES[shape_name]), key, seed)
            mus = _batch_mus(cd, BATCH_TIMED, with_t)
            mu_l, mu_o, mu_n = mus
            held_text = ""
            if shape_name != "taxi":
                tag = f"{variant} batched entry at {BATCH_TIMED}x{shape_name}"
                got = hopper_kernels.elementwise_block_batch(*args, mu_l, mu_o, SCALARS[2], mu_l_next=mu_n, **kw)
                max_abs = _hold_batch_against_plain(tag, args, got, mus, key)
                _hold_batch_per_entry(tag, args, got, mus, kw)
                del got
                held += BATCH_TIMED
                held_text = (f"; held against the plain version (max_abs_err={max_abs:.3e}) and bitwise to "
                             f"{BATCH_TIMED} pointer launches")
            entries = [tuple(a[i] for a in args) for i in range(BATCH_TIMED)]
            calls = {
                "batch": lambda: hopper_kernels.elementwise_block_batch(*args, mu_l, mu_o, SCALARS[2],
                                                                        mu_l_next=mu_n, **kw),
                "pointer": lambda: [hopper_kernels._block_cuda(*entries[i], mu_l[i], mu_o[i], SCALARS[2],
                                                               None if mu_n is None else mu_n[i], **kw)
                                    for i in range(BATCH_TIMED)],
            }
            t_dtype = t_dt if with_t else None
            ms, _plain, copy_ms, host = _time_pair(None, calls, _block_bytes(args, t_dtype), reps=BATCH_REPS)
            bound_ms, bound_by = _block_bound(args, t_dtype)
            print(f"phase2 batched {BATCH_TIMED}x{shape_name:7s} {variant}: batch={ms['batch'] * 1e3:9.1f} us, "
                  f"{BATCH_TIMED} pointer launches={ms['pointer'] * 1e3:9.1f} us, copy_us={copy_ms * 1e3:8.1f}, "
                  f"host_enqueue={host['batch'] * 1e3:6.1f} / {host['pointer'] * 1e3:6.1f} us, bound="
                  f"{bound_ms * 1e3:.1f} us by {bound_by} ({bound_ms / ms['batch']:.0%} reached; pointer "
                  f"{bound_ms / ms['pointer']:.0%}){held_text}")
            if shape_name == "taxi":
                records[variant].update(batch_ms=ms["batch"], batch_pointer_ms=ms["pointer"],
                                        batch_bound_ms=bound_ms)
            del args, entries, calls
    _release_cached()  # the 4 x video buffers above would pin the allocator's cache for later phases
    print(f"phase2 batched entries: every variant's, {held} entries of batches at "
          f"{', '.join(BATCH_HELD_SHAPES)} ({BATCH_HELD} entries) and phase 22's "
          f"{', '.join(f'{v} {s}' for v, ss in BATCH_MAIN_PATH.items() for s in ss)} ({BATCH_TIMED} entries): every "
          f"store and both sums bitwise the pointer entry's launch on that entry alone")


# An odd count above one resident wave of the widest groups (8 elements).
ODD_ABOVE_A_WAVE = 2 * hopper_kernels.RESIDENT_BLOCKS * hopper_kernels.BLOCK_THREADS * 8 + 13
EDGE_COUNTS = (1, 7, 8, 9, 255, 257, ODD_ABOVE_A_WAVE)


def _phase2_conversion_edges() -> None:
    """Each narrow variant on inputs that put its outputs at the edges of
    the narrow formats (`hopper_kernels.edge_args`: every step exact, so a
    store can differ only by its rounding): every store equal to the plain
    version's on the CPU, `narrow_cast`, bitwise, NaN where it has NaN."""
    edges = hopper_kernels.EDGE_VALUES
    values = edges * 3 + edges[:5]  # whole groups and a one-element tail
    compared = 0
    for variant, (cd, d_dt, s_dt, t_dt) in NARROW.items():
        args = hopper_kernels.edge_args(values, (cd, d_dt, s_dt, t_dt), "cuda")
        mu_next = None if t_dt is None else hopper_kernels.EDGE_MU_NEXT
        got = hopper_kernels._block_cuda(*args, *hopper_kernels.EDGE_SCALARS, mu_l_next=mu_next, t_dtype=t_dt)
        want = hopper_kernels._block_torch(*(a.cpu() for a in args), *hopper_kernels.EDGE_SCALARS,
                                           mu_l_next=mu_next, compute_dtype=cd, store_dtype=s_dt, t_dtype=t_dt)
        torch.cuda.synchronize()
        try:
            compared += hopper_kernels.check_stores_bitwise(got, want)
        except AssertionError as exc:
            raise AssertionError(f"{variant} at the conversion edges: {exc}") from exc
    print(f"phase2 conversion edges: {len(NARROW)} narrow variants, {compared} stores at {len(edges)} "
          f"edge values, each bitwise the plain version's on the CPU (narrow_cast), NaN where it has NaN")
    # every float8 code as D, E, Y_L and Y_O, through every variant that holds that format
    compared, held = 0, 0
    for variant, (cd, d_dt, s_dt, t_dt) in NARROW.items():
        key = (cd, d_dt, s_dt, t_dt if t_dt is not None else s_dt)
        mu_next = None if t_dt is None else hopper_kernels.EDGE_MU_NEXT
        for fmt in sorted(set(key) & set(hopper_kernels.FLOAT8), key=str):
            args = hopper_kernels.float8_code_args(fmt, key, "cuda")
            got = hopper_kernels._block_cuda(*args, *hopper_kernels.EDGE_SCALARS, mu_l_next=mu_next, t_dtype=t_dt)
            want = hopper_kernels._block_torch(*(a.cpu() for a in args), *hopper_kernels.EDGE_SCALARS,
                                               mu_l_next=mu_next, compute_dtype=cd, store_dtype=s_dt, t_dtype=t_dt)
            torch.cuda.synchronize()
            try:
                compared += hopper_kernels.check_stores_bitwise(got, want)
            except AssertionError as exc:
                raise AssertionError(f"{variant} on the 256 codes of {fmt}: {exc}") from exc
            held += 1
    print(f"phase2 float8 codes: all 256 codes of e4m3fn and e5m2 as D, E, Y_L and Y_O through {held} "
          f"(variant, format) pairs, {compared} stores, each bitwise the plain version's on the CPU, NaN where "
          f"it has NaN")


# numerators of the float64 division check (the float32 one takes all 2**32)
QUOTIENT_F64_SAMPLES = 2**28


def _phase2_quotient() -> None:
    """The kernel divides by a launch's mu with a reciprocal made once and
    one correction per element (`Quotient`, csrc/elementwise_block.cuh);
    hold it bitwise to '/' (div.rn): every float32 numerator, and 2**28
    float64 ones, for each divisor of `sweep_block.quotient_divisors`
    (the presets' annealed mu, their sums, powers of two and all-ones
    significands from 2**-32 to 2**31)."""
    from tritd_tpu_torch.tools import sweep_block

    for dtype, count in ((torch.float32, 2**32), (torch.float64, QUOTIENT_F64_SAMPLES)):
        divisors = sweep_block.quotient_divisors(dtype, (COMPLETION_TRITD, VIDEO_TRITD))
        t0 = time.perf_counter()
        counts = sweep_block.quotient_check(dtype, divisors, count)
        seconds = time.perf_counter() - t0
        wrong = {divisors[k]: int(n) for k, n in enumerate(counts[:, 0]) if n}
        if wrong:
            raise AssertionError(f"the kernel's {dtype} division differs from '/' for divisors {wrong}")
        print(f"phase2 division {str(dtype)[6:]}: {len(divisors)} divisors x {count} numerators, every quotient "
              f"bitwise div.rn's; {counts[:, 1].sum() / (count * len(divisors)):.1%} took the reciprocal path "
              f"({seconds:.1f} s)")


def _phase2_edges() -> None:
    """What 16-byte accesses, the grid plan and the folded sum can get
    wrong. Tolerances as in `phase2`."""
    for n in EDGE_COUNTS:
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(n % 1000)
            args = [torch.randn(n, generator=gen, dtype=dtype, device="cuda") for _ in range(5)]
            worst = max(_hold_same_dtype(args, mu_next)[1] for mu_next in (None, MU_NEXT))
            # the same numbers behind pointers one element off a 16-byte boundary
            off = [torch.cat([a.new_zeros(1), a])[1:] for a in args]
            if any(a.data_ptr() % 16 == 0 for a in off):
                raise AssertionError("the shifted views are still 16-byte aligned")
            got, _ = _hold_same_dtype(args, MU_NEXT)
            got_off, worst_off = _hold_same_dtype(off, MU_NEXT)
            for i in (0, 1, 2, 3, 6):  # the same arithmetic per element on either path
                if not torch.equal(got[i], got_off[i]):
                    raise AssertionError(f"n={n} {dtype}: output {i} differs between aligned and shifted inputs")
            # the partition of the two sums may differ between the paths: not bitwise
            rtol = 1e-12 if dtype == torch.float64 else 1e-6
            for i in (4, 5):
                torch.testing.assert_close(got[i], got_off[i], rtol=rtol, atol=0.0)
            print(f"phase2 edge n={n:8d} {str(dtype)[6:]:7s} max_abs_err={max(worst, worst_off):.3e}; pointers "
                  f"off by {args[0].element_size()} B: tensors bitwise equal to the aligned call, sums rtol {rtol:g}")
        # bf16 and float8 storage: groups of 8 (2-byte and 8-byte accesses)
        # beside float, 4 (4-byte accesses of e5m2) beside double
        # and double streams beside float compute, float ones beside double
        for variant in ("c32_dbf16_sbf16_tbf16", "c32_de4m3_se4m3_te4m3", "c64_de5m2_se5m2_te5m2",
                        "c32_d64_s64_tbf16", "c64_d32_s32_t32"):
            storage = NARROW[variant]
            for offset in (0, 1):
                args = _narrow_args((n,), storage, n % 1000, offset)
                if offset and any(a.data_ptr() % 16 == 0 for a in args):
                    raise AssertionError("the shifted views are still 16-byte aligned")
                kw = dict(mu_l_next=MU_NEXT, t_dtype=storage[3])
                got = hopper_kernels._block_cuda(*args, *SCALARS, **kw)
                want = hopper_kernels._block_torch(*args, *SCALARS, compute_dtype=storage[0],
                                                   store_dtype=storage[2], **kw)
                torch.cuda.synchronize()
                agree = hopper_kernels.check_narrow_against_plain(args, got, want, MU_NEXT)
                for i in (4, 5):
                    torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
                off = f"{args[2].element_size()} B off" if offset else "aligned"
                print(f"phase2 edge n={n:8d} {variant}, pointers {off}: "
                      f"max_abs_err={agree['max_abs_err']:.3e} flip share {agree['flip_share']:.3e}")

    # bitwise equal sums from call to call: the order of additions is fixed
    for shape in (KERNEL_SHAPES["slab4"], KERNEL_SHAPES["ragged"], (ODD_ABOVE_A_WAVE,)):
        gen = torch.Generator(device="cuda").manual_seed(7)
        args = [torch.randn(shape, generator=gen, device="cuda") for _ in range(5)]
        sums = {tuple(float(x) for x in hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=MU_NEXT)[4:6])
                for _ in range(20)}
        if len(sums) != 1:
            raise AssertionError(f"{shape}: the two sums differ between 20 calls on the same inputs: {sums}")
        print(f"phase2 sums {shape}: bitwise equal over 20 calls")

    # two streams at once: each has its own scratch and counter
    for shape in (KERNEL_SHAPES["slab4"], KERNEL_SHAPES["ragged"]):
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        cases = []
        for seed in (11, 12):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            args = [torch.randn(shape, generator=gen, device="cuda") for _ in range(5)]
            cases.append((args, _hold_same_dtype(args, MU_NEXT)[0]))
        torch.cuda.synchronize()
        for _ in range(50):
            got = []
            for stream, (args, _first) in zip(streams, cases):
                with torch.cuda.stream(stream):
                    got.append(hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=MU_NEXT))
            torch.cuda.synchronize()
            for out, (_args, first) in zip(got, cases):
                if not all(torch.equal(out[i], first[i]) for i in (0, 1, 2, 3, 4, 5, 6)):
                    raise AssertionError(f"{shape}: a call beside another stream's differs from the call alone")
        keys = {key for key in hopper_kernels._SCRATCH if key[1] in {st.cuda_stream for st in streams}}
        if len(keys) != 2:
            raise AssertionError(f"the two streams do not have a scratch each: {sorted(hopper_kernels._SCRATCH)}")
        print(f"phase2 streams {shape}: 50 turns of two streams at once, each bitwise equal to its call alone "
              f"(held against the plain version)")


def phase2() -> dict:
    """Kernel vs plain version on the card. Same-dtype variants: tensors
    rtol 1e-6 with atol 1e-6 * max|input| (nvcc contracts a*b+c into one
    FMA); narrow variants: `hopper_kernels.check_narrow_against_plain` -
    bf16 tensors within one bf16 ulp, rtol 2**-8 with atol 2**-8 *
    max|input| (such an FMA can flip one rounding), with at most a share
    NARROW_FLIP_SHARE of their elements rounded otherwise (float32 stores
    beside float64 compute the same way, to one float32 step and
    F32_AT_F64_FLIP_SHARE), and T' bitwise from the stored O' and Y_L';
    norms rtol 1e-5 (the kernel sums in double, the plain version in the
    dtype). Each variant at every shape phase 3 gives it.
    Returns the taxi-shape record of each variant the main path runs."""
    records = {}
    for seed, (dtype, (name, shape)) in enumerate(
        (dt, item) for dt in (torch.float32, torch.float64) for item in KERNEL_SHAPES.items()
    ):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        args = [torch.randn(shape, generator=gen, dtype=dtype, device="cuda") for _ in range(5)]
        for mu_next in (None, MU_NEXT):
            _, max_abs = _hold_same_dtype(args, mu_next)
            t_dtype = None if mu_next is None else dtype
            record = _report(
                f"{name:6s} {str(dtype)[6:]:7s} t'={'yes' if mu_next else 'no '}", args, t_dtype, max_abs,
                lambda: hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next),
                dict(mu_l_next=mu_next, t_dtype=None), pointer=name == "taxi",
            )
            if name == "taxi" and mu_next is not None:
                records[str(dtype)[6:].replace("float", "f")] = record

    # every shape phase 3 gives a variant: its video solves, and the coverage
    # solves of the variants that round to float8_e4m3fn
    at_video = {_variant_of(f) for data, f, _i, _e in NARROW_SOLVES if data == "video"}
    at_video |= {v for v in NARROW if "e4m3" in v}
    for seed, (variant, (cd, d_dt, s_dt, t_dt)) in enumerate(NARROW.items(), start=100):
        if cd == torch.float32:
            shapes = ("taxi", "video", "slab2")
        else:
            shapes = ("taxi", "video") if variant in at_video else ("taxi",)
        for name in shapes:
            args = _narrow_args(KERNEL_SHAPES[name], (cd, d_dt, s_dt, t_dt), seed)
            if hopper_kernels.kernel_variant(*args, t_dtype=t_dt) != variant:
                raise AssertionError(f"{variant}: dtypes route to another variant")
            mu_next = None if t_dt is None else MU_NEXT
            kw = dict(mu_l_next=mu_next, t_dtype=t_dt)
            plain_kw = dict(mu_l_next=mu_next, compute_dtype=cd, store_dtype=s_dt, t_dtype=t_dt)
            got = hopper_kernels._block_cuda(*args, *SCALARS, **kw)
            want = hopper_kernels._block_torch(*args, *SCALARS, **plain_kw)
            torch.cuda.synchronize()
            agree = hopper_kernels.check_narrow_against_plain(args, got, want, mu_next)
            _hold_pointer_entry(args, got, mu_next, t_dt)
            max_abs = agree["max_abs_err"]
            limits = hopper_kernels.rounding_limits(s_dt, cd) or hopper_kernels.rounding_limits(t_dt, cd)
            for i in (4, 5):
                torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
            record = _report(
                f"{name:6s} {variant}", args, t_dt, max_abs,
                lambda: hopper_kernels._block_torch(*args, *SCALARS, **plain_kw), kw, pointer=name == "taxi",
            )
            held = "; T' bitwise from the stored O', Y_L'" if t_dt is not None else ""
            if limits is not None:
                print(f"phase2 {name:6s} {variant} elements narrower than compute rounded otherwise than the "
                      f"plain version: share {agree['flip_share']:.3e} (limit {limits[1]:.1e}){held}")
            else:
                print(f"phase2 {name:6s} {variant} float32/float64 outputs within rtol 1e-6 of the plain "
                      f"version{held}")
            if name == "taxi":
                records[variant] = record
    _phase2_conversion_edges()
    _phase2_quotient()
    _phase2_edges()
    _phase2_batch(records)
    missing = set(hopper_kernels.KERNEL_VARIANTS.values()) - set(POINTER_HELD)
    if missing:
        raise AssertionError(f"pointer entries not held to their by-value entries: {sorted(missing)}")
    print(f"phase2 pointer entries: {sum(POINTER_HELD.values())} calls of all {len(POINTER_HELD)} variants' "
          f"pointer entries (penalties read from device memory), every store and both sums bitwise the "
          f"by-value entry's on the same inputs")
    return records


def _launches() -> dict:
    """The kernel variants launched since the last reset, with their counts."""
    return {k[len("elementwise_block["):-1]: v for k, v in hopper_kernels.LAUNCHES.items() if v}


def _pointer_launches() -> dict:
    """Of those, the launches through the variants' pointer entries."""
    return {k[len("elementwise_block_ptr["):-1]: v for k, v in hopper_kernels.POINTER_LAUNCHES.items() if v}


# the main path's launches through the pointer entries (phases 3, 5, 12, 17, 19)
POINTER_ON_MAIN_PATH: dict = {}


def _tally_pointer(counts: dict) -> None:
    for k, v in counts.items():
        POINTER_ON_MAIN_PATH[k] = POINTER_ON_MAIN_PATH.get(k, 0) + v


def _all_through_the_pointer_entry(tag: str, launches: dict) -> None:
    """A one-card tritd_admm takes the CUDA graph route, whose every launch,
    the eager first block's too, goes through the pointer entry."""
    pointer = _pointer_launches()
    if pointer != launches:
        raise AssertionError(f"{tag}: launches through the pointer entry {pointer}, want all of {launches}")
    _tally_pointer(pointer)


def _solve(y, cfg, init, origin=None, mask=None) -> tuple:
    """One timed solve: CUDA events around it and a final synchronize. A
    3-iteration solve first takes the one-time cuBLAS/cuSOLVER set-up out of
    the timed run; the launch counts cover the timed run only."""
    tritd_admm(y, dataclasses.replace(cfg, max_iter=3), origin=origin, init=init, mask=mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hopper_kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = tritd_admm(y, cfg, origin=origin, init=init, mask=mask)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, _launches(), start.elapsed_time(end) / 1e3, wall


def _nan_tail(err: np.ndarray) -> int | None:
    """Where err_hist turns non-finite for good (None if it never does);
    raises if it turns finite again after."""
    bad = ~np.isfinite(err)
    if not bad.any():
        return None
    first = int(np.argmax(bad))
    if not bad[first:].all():
        raise AssertionError(f"err_hist is non-finite at iteration {first + 1} and finite after: {err}")
    return first


def _finite_prefix(err: np.ndarray) -> int:
    """How many leading err_hist entries are finite."""
    tail = _nan_tail(err)
    return len(err) if tail is None else tail


@contextlib.contextmanager
def _t_rounded_toward_zero():
    """A planted fault for phase 3's controls: while it is on, the plain
    block rounds T' toward zero where it should round to nearest, one step
    of T's dtype on about half of the elements."""
    plain = hopper_kernels._block_torch

    def faulty(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, compute_dtype=None, store_dtype=None,
               t_dtype=None):
        out = plain(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, compute_dtype, store_dtype, t_dtype)
        t = out[6]
        if t is None:
            return out
        cd = compute_dtype or d.dtype
        exact = d.to(cd) - out[0].to(cd) + out[2].to(cd) / float(mu_l_next)
        wide = t.to(cd)
        away = (wide.abs() > exact.abs()) & torch.isfinite(wide) & (wide != 0)
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        # sign and magnitude: one less in the magnitude bits is one step nearer 0
        return (*out[:6], torch.where(away, t.view(bits) - 1, t.view(bits)).view(t.dtype))

    hopper_kernels._block_torch = faulty
    try:
        yield
    finally:
        hopper_kernels._block_torch = plain


def _check_run(tag, res, launches, variant, dev_s, wall, truth, float8=False) -> tuple[float, np.ndarray]:
    """Launches once per iteration, err_hist finite and falling, O back in
    the factors' dtype on the card, RRE against the truth finite and below
    1. A float8 run (`float8`) may diverge after it fell, and turn
    non-finite for good: its err_hist must fall below its first entry while
    it is finite. The reference does so too at full size on the CPU, at an
    iteration that a one-step change of the input moves by as much as the
    two packages differ (docs/float8_nan_study.py)."""
    n = res.n_iters
    err = trim_history(res.err_hist, n)
    if launches != {variant: n}:
        raise AssertionError(f"{tag}: launches {launches}, want {{{variant!r}: {n}}}")
    tail = _nan_tail(err) if float8 else None
    held = err[:tail]
    fell = held.min() < held[0] if float8 else held[-1] < held[0]
    if not (len(held) > 1 and np.isfinite(held).all() and fell):
        raise AssertionError(f"{tag}: err_hist not finite and falling: {err}")
    if res.o.dtype != res.a.dtype or res.o.device.type != "cuda":
        raise AssertionError(f"{tag}: O comes back in {res.o.dtype} on {res.o.device}")
    rre_truth = float(rre(triple_product(res.a, res.b, res.c), truth.to(res.a.dtype)))
    if not float8 and not (np.isfinite(rre_truth) and rre_truth < 1.0):
        raise AssertionError(f"{tag}: RRE vs truth {rre_truth}")
    print(f"phase3 {tag}: iters={n} launches={launches} solve={dev_s:.4f} s (events) {wall:.4f} s (wall) "
          f"{dev_s / n * 1e3:.3f} ms/iter peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"rre={rre_truth:.6f} err[0]={err[0]:.4e} err[-1]={err[-1]:.4e}")
    return rre_truth, err


# Phase 3's CPU references run in worker processes while the card solves
# go on: spawned (a forked CUDA process is unusable), each pinned to
# CPU_REF_THREADS intra-op threads, so that they share the machine's eight
# cores with the process that drives the card. main() shuts the pool down.
CPU_REF_WORKERS = 3
CPU_REF_THREADS = 2
_CPU_POOL: list = []


def _cpu_pool():
    if not _CPU_POOL:
        import concurrent.futures
        import multiprocessing

        _CPU_POOL.append(concurrent.futures.ProcessPoolExecutor(
            CPU_REF_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _CPU_POOL[0]


def _cpu_reference(data, cfg, init, origin, mask, planted=False) -> tuple:
    """(function, arguments) for the pool: the err_hist of tritd_admm on the
    CPU, cfg.max_iter iterations in cfg's dtypes, with these inputs as numpy
    (the pipe carries them by value; with `planted`, T' rounded toward
    zero)."""
    as_np = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    return (_cpu_err_hist, as_np(data), cfg, tuple(as_np(f) for f in init), as_np(origin), as_np(mask), planted)


def _cpu_err_hist(data, cfg, init, origin, mask, planted) -> tuple[np.ndarray, float]:
    """In a worker of `_cpu_pool()`: (the err_hist, seconds) of `_cpu_reference`'s solve."""
    torch.set_num_threads(CPU_REF_THREADS)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    t0 = time.perf_counter()
    with _t_rounded_toward_zero() if planted else contextlib.nullcontext():
        res = tritd_admm(t(data), cfg, init=tuple(map(t, init)), origin=t(origin), mask=t(mask))
    return trim_history(res.err_hist, cfg.max_iter), time.perf_counter() - t0


def _taxi():
    x_np, _spec, prov = load_dataset("taxi")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO),
                           device="cuda")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    return x, mask, torch.where(mask, x, torch.zeros_like(x)), prov


def phase3() -> tuple:
    """The main path; returns the launches of each kernel variant in it and
    the function that holds its solves to their CPU references (`checks`)."""
    total: dict = {}

    ms_per_iter: dict = {}  # of the last run of each variant

    def run(tag, y, cfg, init, variant, truth, origin=None, mask=None):
        res, launches, dev_s, wall = _solve(y, cfg, init, origin=origin, mask=mask)
        _all_through_the_pointer_entry(tag, launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ms_per_iter[variant] = dev_s / res.n_iters * 1e3
        return (res, *_check_run(tag, res, launches, variant, dev_s, wall, truth))

    # taxi completion: the primary row of the reference benchmark
    x, mask, y, prov = _taxi()
    cfg = COMPLETION_TRITD
    init = init_factors(torch.Generator().manual_seed(0), x.shape, cfg.rank, torch.float32)
    res, rre32, err = run(f"taxi ({prov}) 100x100x500 r=5 f32", y, cfg, init, "f32", x, origin=x)
    taxi_ms = ms_per_iter["f32"]

    # the first 10 iterations again, float64 on the CPU, from the same init
    f64_rerun = _cpu_pool().submit(*_cpu_reference(y.double(), dataclasses.replace(cfg, dtype="float64", max_iter=10),
                                                init, x.double(), None))

    # video protocol: fully observed
    v_np, _vspec, vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    vinit = init_factors(torch.Generator().manual_seed(0), v.shape, VIDEO_TRITD.rank, torch.float32)
    _, vrre32, _ = run(f"video highway ({vprov}) 240x320x300 r=5 f32", v, VIDEO_TRITD, vinit, "f32", v)
    video_ms = ms_per_iter["f32"]

    # narrow storage and the bf16 einsum (the reference bench's bf16 rows)
    narrow = [
        ("taxi storage=bf16", y, dataclasses.replace(cfg, storage_dtype="bfloat16"), init,
         "c32_dbf16_sbf16_tbf16", x, rre32),
        ("video highway storage=bf16", v, dataclasses.replace(VIDEO_TRITD, storage_dtype="bfloat16"), vinit,
         "c32_dbf16_sbf16_tbf16", v, vrre32),
        ("taxi einsum=bf16", y, dataclasses.replace(cfg, einsum_dtype="bfloat16"), init,
         "c32_d32_s32_tbf16", x, rre32),
    ]
    for tag, data, ncfg, ninit, variant, truth, wide_rre in narrow:
        origin = truth if truth is x else None
        _, nrre, _ = run(tag, data, ncfg, ninit, variant, truth, origin=origin)
        if abs(nrre - wide_rre) > RRE_FAMILY:
            raise AssertionError(f"{tag}: RRE {nrre} vs f32 {wide_rre}, beyond {RRE_FAMILY}")

    # masked imputation, f32 and bf16 storage
    mcfg = dataclasses.replace(cfg, masked=True)
    _, mrre32, _ = run("taxi masked f32", y, mcfg, init, "f32", x, origin=x, mask=mask)
    _, mrre16, _ = run("taxi masked storage=bf16", y, dataclasses.replace(mcfg, storage_dtype="bfloat16"),
                       init, "c32_d32_sbf16_tbf16", x, origin=x, mask=mask)
    if abs(mrre16 - mrre32) > RRE_FAMILY:
        raise AssertionError(f"taxi masked: bf16 RRE {mrre16} vs f32 {mrre32}, beyond {RRE_FAMILY}")

    # the same four taxi solves with float64 compute, cut to 20 iterations
    cfg64 = dataclasses.replace(cfg, dtype="float64", max_iter=20)
    for tag, fields, variant, masked in (
        ("f64", {}, "f64", False),
        ("f64 storage=bf16", {"storage_dtype": "bfloat16"}, "c64_dbf16_sbf16_tbf16", False),
        ("f64 einsum=bf16", {"einsum_dtype": "bfloat16"}, "c64_d64_s64_tbf16", False),
        ("f64 masked storage=bf16", {"storage_dtype": "bfloat16", "masked": True}, "c64_d64_sbf16_tbf16", True),
    ):
        res64, _, _ = run(f"taxi {tag}", y, dataclasses.replace(cfg64, **fields), init, variant, x,
                          origin=x, mask=mask if masked else None)
        if res64.a.dtype != torch.float64:
            raise AssertionError(f"taxi {tag}: factors come back in {res64.a.dtype}")

    # highway with README_MISSING_RATIO of it missing, for the masked
    # float8_e4m3fn variants, which taxi's 526.1 turns NaN
    vmask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), v.shape, README_MISSING_RATIO),
                            device="cuda")
    problems = {("taxi", False): (y, cfg, init, x, None), ("taxi", True): (y, cfg, init, x, mask),
                ("video", False): (v, VIDEO_TRITD, vinit, v, None),
                ("video", True): (torch.where(vmask, v, torch.zeros_like(v)), VIDEO_TRITD, vinit, v, vmask)}
    wide_rre = {("taxi", False): rre32, ("video", False): vrre32, ("taxi", True): mrre32}
    finite = set(total)  # the variants launched so far on finite data
    controlled: set = set()  # the einsum dtypes whose control has run

    def plan():
        yield from NARROW_SOLVES
        for name in hopper_kernels.KERNEL_VARIANTS.values():
            if name not in finite:
                data = "video" if "e4m3" in name else "taxi"
                iters = (WIDE_COVERAGE_ITERS if name in WIDE else COVERAGE_ITERS)[data]
                yield data, _fields_of(name), iters, None

    # First every solve on the card, each one's CPU reference handed to the
    # pool as it ends; then, as the references come back, the checks.
    solves = []
    for data, fields, iters, expect in plan():
        dtype = fields.get("dtype", "float32")
        masked = fields.get("masked", False)
        label = " ".join(f"{k.split('_')[0]}={_short(v)}" for k, v in fields.items()
                         if k != "masked" and (k, v) != ("dtype", "float32"))
        if masked:
            label = "masked " + label
        tag = f"{data} {label} ({iters} iterations)"
        variant = _variant_of(fields)
        data_t, preset, ninit, truth, dmask = problems[data, masked]
        ncfg = dataclasses.replace(preset, max_iter=iters, **fields)
        origin = truth if data == "taxi" else None
        nres, launches, dev_s, wall = _solve(data_t, ncfg, ninit, origin=origin, mask=dmask)
        _all_through_the_pointer_entry(tag, launches)
        for k, val in launches.items():
            total[k] = total.get(k, 0) + val
        if launches != {variant: nres.n_iters}:
            raise AssertionError(f"{tag}: launches {launches}, want {{{variant!r}: {nres.n_iters}}}")
        # the same solve on the CPU in the same dtypes: its first 10 iterations
        depth = min(10, iters)
        cpu_job = (data_t, dataclasses.replace(ncfg, max_iter=depth), ninit, origin, dmask)
        got = trim_history(nres.err_hist, nres.n_iters)
        solve = dict(tag=tag, data=data, fields=fields, iters=iters, expect=expect, dtype=dtype, masked=masked,
                     variant=variant, ncfg=ncfg, preset=preset, depth=depth, cpu_job=cpu_job, got=got,
                     n_iters=nres.n_iters, launches=launches, dev_s=dev_s, data_max=float(data_t.abs().max()),
                     future=_cpu_pool().submit(*_cpu_reference(*cpu_job)))
        float8 = "float8" in str(fields)
        if expect != "nan" and _finite_prefix(got[:depth]) == depth:
            # the card's own checks; the CPU run must then be finite over the held iterations too
            solve["check"] = _check_run(tag, nres, launches, variant, dev_s, wall, truth, float8=float8)
            solve["tail"] = _nan_tail(got) if float8 else None
        if expect != "nan":
            finite.add(variant)  # asserted below, with the CPU run
        solves.append(solve)
        del nres

    def checks() -> None:
        """Phase 3's checks against its CPU references, collected when they
        return: `_main` calls it after the card's later phases, which the
        references' worker processes overlap."""
        for solve in solves:
            want, cpu_s = solve["future"].result()
            solve.update(want=want, cpu_s=cpu_s)
        # the controls: with T' rounded toward zero on the CPU, once for each
        # T dtype with and without feedback, on the first solve that holds
        # TIGHT_ENTRIES entries
        for solve in solves:
            if solve["expect"] == "nan":
                continue
            depth, want, got = solve["depth"], solve["want"], solve["got"]
            cpu_k, card_k = _finite_prefix(want), _finite_prefix(got[:depth])
            rise = np.flatnonzero(want[:cpu_k] > want[0])
            solve["held"] = held = min(cpu_k, card_k, int(rise[0]) if rise.size else depth)
            solve.update(cpu_k=cpu_k, card_k=card_k)
            fields = solve["fields"]
            t_dt = t_dtype_of(solve["ncfg"])
            feedback = bool(fields.get("einsum_dtype") or solve["masked"])
            kind = (t_dt, feedback)
            if (t_dt in hopper_kernels.NARROW_ULP and not solve["masked"] and kind not in controlled
                    and held >= TIGHT_ENTRIES):
                controlled.add(kind)
                solve["control"] = _cpu_pool().submit(*_cpu_reference(*solve["cpu_job"], planted=True))
            solve.update(feedback=feedback, t_dt=t_dt)

        for solve in solves:
            tag, want, got, depth = solve["tag"] + f" [CPU reference {solve['cpu_s']:.1f} s]", solve["want"], \
                solve["got"], solve["depth"]
            fields, masked, launches, dev_s, n_iters = (solve[k] for k in ("fields", "masked", "launches", "dev_s",
                                                                             "n_iters"))
            if solve["expect"] == "nan":
                # a value past float8_e4m3fn's 448 is NaN in the reference's
                # rounding: the solve is NaN from its first iteration on
                if not np.isnan(want).all() or n_iters != solve["iters"] or np.isfinite(got).any():
                    raise AssertionError(f"{tag}: err_hist {got} on the card, {want} on the CPU; want NaN throughout")
                print(f"phase3 {tag}: iters={n_iters} launches={launches} solve={dev_s:.4f} s (events) "
                      f"{dev_s / n_iters * 1e3:.3f} ms/iter; err_hist non-finite from iteration 1, as on the CPU "
                      f"and in the reference (max |D| {solve['data_max']:.1f} > 464)")
                continue
            # Both runs are held where both are finite and the CPU's has not
            # risen above its first entry; where the CPU run turns non-finite
            # within the held iterations, the card's must too.
            cpu_k, card_k, held = solve["cpu_k"], solve["card_k"], solve["held"]
            if held == 0 or (cpu_k < depth) != (card_k < depth):
                raise AssertionError(f"{tag}: err_hist {got[:depth]} on the card, {want} on the CPU")
            narrow = [fields.get("storage_dtype"), fields.get("einsum_dtype")]
            feedback = solve["feedback"]
            tail_rtol = FLOAT8_FEEDBACK_RTOL if E4M3 in narrow or E5M2 in narrow else FEEDBACK_RTOL
            limits = np.array([(FEEDBACK_RTOL if k < TIGHT_ENTRIES else tail_rtol) if feedback else NO_FEEDBACK_RTOL
                               for k in range(held)])
            rel = np.abs(got[:held] - want[:held]) / np.abs(want[:held])
            if (rel > limits).any():
                raise AssertionError(f"{tag}: first {held} err_hist entries {rel} from the CPU run, limits {limits}")
            head = rel[:TIGHT_ENTRIES].max()
            reading = f"first {min(held, TIGHT_ENTRIES)} {head:.3e} (rtol {limits[0]:g})"
            if held > TIGHT_ENTRIES:
                reading += f", entries {TIGHT_ENTRIES + 1}-{held} {rel[TIGHT_ENTRIES:].max():.3e} (rtol {limits[-1]:g})"
            control = ""
            if "control" in solve:
                bad, _s = solve["control"].result()
                t_dt = solve["t_dt"]
                moved = float(np.max(np.abs(got[:TIGHT_ENTRIES] - bad[:TIGHT_ENTRIES]) / np.abs(bad[:TIGHT_ENTRIES])))
                float8_t = t_dt in (torch.float8_e4m3fn, torch.float8_e5m2)
                if float8_t and not moved > limits[0]:
                    raise AssertionError(f"{tag}: with T' rounded toward zero the CPU run is {moved:.3e} from the card's, "
                                         f"within rtol {limits[0]:g}: the check does not catch that fault")
                control = (f"; control: with T' rounded toward zero on the CPU, first {TIGHT_ENTRIES} {moved:.3e}"
                           + ("" if float8_t else " (not asserted)"))
            if cpu_k < depth:
                print(f"phase3 {tag}: iters={n_iters} launches={launches} solve={dev_s:.4f} s (events) "
                      f"{dev_s / n_iters * 1e3:.3f} ms/iter; err_hist {got[:depth]} on the card, {want} on the CPU: "
                      f"{reading} over the {held} held; non-finite from iteration {card_k + 1} on the card and "
                      f"{cpu_k + 1} on the CPU{control}")
                continue
            nrre, _err = solve["check"]
            line = f"phase3 {tag}: first {depth} err_hist entries vs the CPU run in the same dtypes: {reading}{control}"
            key = (solve["data"], masked)
            if "float8" not in str(fields) and solve["dtype"] == "float32" and solve["iters"] == solve["preset"].max_iter \
                    and key in wide_rre:
                if abs(nrre - wide_rre[key]) > RRE_FAMILY:
                    raise AssertionError(f"{tag}: RRE {nrre} vs f32 {wide_rre[key]}, beyond {RRE_FAMILY}")
                line += f"; RRE {nrre:.6f} vs f32 {wide_rre[key]:.6f} (family {RRE_FAMILY})"
            else:
                line += f"; RRE {nrre:.6f} (not held to the f32 family)"
            if solve["tail"] is not None:
                line += (f"; non-finite from iteration {solve['tail'] + 1} on, finite before (float8 range passed, as "
                         f"in the reference at this size: docs/float8_nan_study.py)")
            print(line)
        for kind in [(dt, fb) for dt in (torch.float8_e4m3fn, torch.float8_e5m2) for fb in (False, True)]:
            if kind not in controlled:
                print(f"phase3 no control for T' in {kind[0]} {'with' if kind[1] else 'without'} feedback: no such "
                      f"solve holds {TIGHT_ENTRIES} finite entries")
        ref, _s = f64_rerun.result()
        m = min(len(ref), res.n_iters)
        np.testing.assert_allclose(err[:m], ref[:m], rtol=1e-3)
        print(f"phase3 taxi f32 cuda vs f64 cpu, first {m} iterations: "
              f"max rel diff {np.max(np.abs(err[:m] - ref[:m]) / np.abs(ref[:m])):.3e} (rtol 1e-3)")
        missing = set(hopper_kernels.KERNEL_VARIANTS.values()) - finite
        print(f"phase3 variants launched on finite data: {len(finite)} of {len(finite) + len(missing)}; "
              f"only on NaN data: {sorted(missing)}")

    T1_ROWS.extend([
        {"name": "taxi", "shape": list(x.shape), "rank": cfg.rank, "ms_per_iter": taxi_ms, "card": CARD[0]},
        {"name": "video", "shape": list(v.shape), "rank": VIDEO_TRITD.rank, "ms_per_iter": video_ms, "card": CARD[0]},
    ])
    return total, checks


def phase4() -> None:
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "tritd_tpu_torch.cli.run_completion", "--datasets", "taxi",
             "--methods", "triple", "--missing-ratio", "0.10", "--out-dir", out],
            capture_output=True, text=True, cwd=HERE, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        row = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        if not (row["dataset"] == "taxi" and row["method"] == "triple" and row["device"] == "cuda"
                and 0 < row["iters"] <= 100 and 0.0 < row["rre"] < 1.0):
            raise AssertionError(f"CLI row: {row}")
        with np.load(os.path.join(out, "taxi_triple_errHist.npz")) as f:
            hist = f["errHist"]
        if hist.shape != (row["iters"],) or not np.isfinite(hist).all():
            raise AssertionError(f"CLI artifact: shape {hist.shape}")
        print(f"phase4 cli: {json.dumps(row)}")


_DRILL = """
import dataclasses, sys, numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
from tritd_tpu_torch.solvers import tritd_admm_checkpointed
from tritd_tpu_torch.utils.config import COMPLETION_TRITD
y = torch.from_numpy(np.load(sys.argv[1])).cuda()
tritd_admm_checkpointed(y, dataclasses.replace(COMPLETION_TRITD, max_iter=50), sys.argv[2], every=25)
sys.exit(3)
"""


def phase5() -> dict:
    """Checkpointed resume on the card (taxi, f32, every=25, 50 iterations),
    on the graph route; returns the launches of the resume and the
    uninterrupted run (the main path)."""
    _x, _mask, y, _prov = _taxi()
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=50)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "y.npy"), y.cpu().numpy())
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _DRILL, os.path.join(tmp, "y.npy"), ckpt],
            capture_output=True, text=True, cwd=HERE, timeout=600,
            env=dict(os.environ, TRITD_DIE_AFTER_SAVE_STEP="25"),
        )
        if proc.returncode != 17:
            raise RuntimeError(f"kill drill: exit {proc.returncode}, want 17:\n{proc.stdout}\n{proc.stderr}")
        if sorted(os.listdir(ckpt)) != ["step_000025.npz"]:
            raise AssertionError(f"kill drill left {sorted(os.listdir(ckpt))}")
        drill_s = time.perf_counter() - t0
        hopper_kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        resumed = tritd_admm_checkpointed(y, cfg, ckpt, every=25)
        end.record()
        torch.cuda.synchronize()
        resume_launches = _launches()
        _all_through_the_pointer_entry("phase5 resume", resume_launches)
        hopper_kernels.reset_launch_counts()
        t1 = time.perf_counter()
        full = tritd_admm_checkpointed(y, cfg, os.path.join(tmp, "full"), every=25)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t1
        full_launches = _launches()
        _all_through_the_pointer_entry("phase5 uninterrupted", full_launches)
    if resumed.n_iters != 50 or resume_launches != {"f32": 25} or full_launches != {"f32": 50}:
        raise AssertionError(f"resume: n_iters {resumed.n_iters}, launches {resume_launches} / {full_launches}")
    for f in ("err_hist", "a", "b", "c", "o", "e"):
        torch.testing.assert_close(getattr(resumed, f), getattr(full, f), rtol=0, atol=0, equal_nan=True)
    mono = tritd_admm(y, cfg)
    np.testing.assert_allclose(resumed.err_hist.cpu().numpy(), mono.err_hist.cpu().numpy(), rtol=1e-6)
    same = bool(torch.equal(resumed.err_hist, mono.err_hist))
    print(f"phase5 checkpoint: drill exit 17 after step 25 in {drill_s:.2f} s (subprocess); resume 25->50 "
          f"{start.elapsed_time(end) / 1e3:.4f} s (events); uninterrupted 50 iterations with 2 saves "
          f"{full_s:.4f} s (wall); resumed == uninterrupted bitwise; vs tritd_admm rtol 1e-6 "
          f"(bitwise: {same}); launches through the pointer entry {resume_launches} / {full_launches}")
    return {"f32": resume_launches["f32"] + full_launches["f32"]}


def phase6() -> None:
    """The other first-party solvers on the card."""
    def timed(fn):
        hopper_kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end) / 1e3

    v_np, _spec, _prov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    x_np, _spec, _prov = load_dataset("taxi")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    tritd_admm_outlier(v, OutlierConfig(max_iter=2), generator=gen())  # set-up out of the timing
    runs = [
        ("outlier highway 240x320x300", lambda: tritd_admm_outlier(v, OutlierConfig(), generator=gen())),
        ("als taxi 100x100x500", lambda: tritd_als(x, TriTDConfig(), generator=gen())),
        ("mals taxi 100x100x500", lambda: tritd_mals(x, TriTDConfig(), generator=gen())),
    ]
    for tag, fn in runs:
        res, dev_s = timed(fn)
        n = res.n_iters
        err = trim_history(res.err_hist, n)
        if not (n > 1 and np.isfinite(err).all() and err[-1] < err[0]):
            raise AssertionError(f"{tag}: err_hist not finite and falling over {n} iterations: {err}")
        print(f"phase6 {tag}: iters={n} solve={dev_s:.4f} s (events) {dev_s / n * 1e3:.3f} ms/iter "
              f"err[0]={err[0]:.4e} err[-1]={err[-1]:.4e}")


def phase7() -> None:
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tritd_tpu_torch.cli.run_video", "--datasets", "highway",
             "--method", "triple", "--out-dir", out],
            capture_output=True, text=True, cwd=HERE, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"video CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        row = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        bad = [k for k in ("psnr", "ssim", "f1", "pwc", "map") if not np.isfinite(row.get(k, np.nan))]
        if bad or row["device"] != "cuda" or row["iters"] != 100 or row["dataset"] != "highway":
            raise AssertionError(f"video CLI row (not finite: {bad}): {row}")
        for what in ("errHist", "Xhat", "O"):
            if not os.path.exists(os.path.join(out, f"highway_triple_{what}.npz")):
                raise AssertionError(f"video CLI artifact {what} missing")
        print(f"phase7 video cli ({time.perf_counter() - t0:.1f} s in all): {json.dumps(row)}")


def _events(fn) -> tuple:
    """(fn(), seconds between CUDA events around it, peak MiB allocated in it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3, torch.cuda.max_memory_allocated() / 2**20


def _on_card(tag, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise AssertionError(f"{tag}: a result lies on {t.device}")


def _matrix_with_spectrum(p: int, q: int, spectrum: torch.Tensor, seed: int) -> torch.Tensor:
    """A float32 (p, q) matrix on the card with the given singular values
    (min(p, q) of them), its singular vectors drawn from `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = min(p, q)
    u = torch.linalg.qr(torch.randn((p, k), generator=gen, device="cuda"))[0]
    v = torch.linalg.qr(torch.randn((q, k), generator=gen, device="cuda"))[0]
    return (u * spectrum.to("cuda")[None, :]) @ v.T


SVT_TAU = 2.0  # the ref-compat gate then sits at 3: the spectra below keep away from both
LINALG_EIGH_SIZES = (512, 1024, 2016, 4800)
# the unfoldings the SVT baselines cut the taxi tensor into (ttnn, ring, fctn)
LINALG_SVD_SHAPES = ((100, 50000), (10000, 500), (50000, 100), (5000, 1000), (1000, 5000))


def _gesvdj_route(m: torch.Tensor, shrink) -> torch.Tensor:
    """The SVT's svd route with gesvdj's SVD in place of the Jacobi kernel."""
    from tritd_tpu_torch.ops import device_linalg

    u, s, vh, _info = device_linalg.svd_with_info(m)
    return (u * shrink(s)[None, :]) @ vh


def phase8() -> None:
    """The SVT routes on the card, and the torch.linalg calls under them."""
    from tritd_tpu_torch.baselines.trpca import prox_tnn
    from tritd_tpu_torch.ops import svt as svt_ops
    from tritd_tpu_torch.runtime import native

    if not native.available():
        raise AssertionError("the host proximal library (csrc/proximal.cpp) did not build")
    got = native.flsa(np.array([3.0, 3.2, -1.0, -1.1, 4.0]), 0.1, 0.2)
    if got.shape != (5,) or not np.isfinite(got).all():
        raise AssertionError(f"native flsa: {got}")
    print("phase8 host proximal library: built, flsa answers")

    for seed, (p, q) in enumerate(((100, 50000), (1000, 5000))):
        k = min(p, q)
        spectrum = torch.cat([torch.linspace(60.0, 12.0, 20), torch.linspace(1.5, 0.1, k - 20)])
        m = _matrix_with_spectrum(p, q, spectrum, seed)
        atol = 1e-4 * float(torch.linalg.vector_norm(m))
        for name, exact, warm in (("svt_ref_compat", svt_ops.svt_ref_compat, svt_ops.svt_ref_compat_warm),
                                  ("svt", svt_ops.svt, svt_ops.svt_warm)):
            methods = ("svd", "gram", "lowrank:64") if name == "svt_ref_compat" else ("svd", "gram")
            for method in methods:  # the library's one-time set-up stays out of the times
                exact(m, SVT_TAU, method)
            _gesvdj_route(m, svt_ops._plain_shrink(SVT_TAU))
            want, svd_s, _ = _events(lambda: exact(m, SVT_TAU, "svd"))
            gram, gram_s, _ = _events(lambda: exact(m, SVT_TAU, "gram"))
            fresh, basis = warm(m, SVT_TAU, torch.eye(k, device="cuda"), True)
            stale, _ = warm(m, SVT_TAU, basis, False)
            # the svd route is the Jacobi kernel at these shapes; gesvdj's route beside it
            shrink = (svt_ops._ref_compat_shrink if name == "svt_ref_compat" else svt_ops._plain_shrink)(SVT_TAU)
            gesvdj, gesvdj_s, _ = _events(lambda: _gesvdj_route(m, shrink))
            routes = {"gesvdj svd": gesvdj, "gram": gram, "warm refresh": fresh, "warm stale on the same matrix": stale}
            if name == "svt_ref_compat":
                routes["lowrank:64"], low_s, _ = _events(lambda: exact(m, SVT_TAU, "lowrank:64"))
            _on_card(f"phase8 {name} {p}x{q}", want, *routes.values())
            diffs = {r: float((out - want).abs().max()) for r, out in routes.items()}
            bad = {r: d for r, d in diffs.items() if not d <= atol}
            # both operators keep the 20 large components, each less tau: the
            # svd route itself is held to that known norm
            norm, norm_want = float(torch.linalg.vector_norm(want)), float(torch.linalg.vector_norm(spectrum[:20] - SVT_TAU))
            if bad or abs(norm - norm_want) > 1e-3 * norm_want:
                raise AssertionError(f"phase8 {name} {p}x{q}: beyond atol {atol:.3e} of the svd route: {bad}; "
                                     f"||svd route|| {norm} against {norm_want} from the spectrum")
            times = f"svd (jacobi) {svd_s * 1e3:.1f} ms, gesvdj {gesvdj_s * 1e3:.1f} ms, gram {gram_s * 1e3:.1f} ms" + (
                f", lowrank:64 {low_s * 1e3:.1f} ms" if name == "svt_ref_compat" else "")
            print(f"phase8 {name} {p}x{q} f32 against the svd route (atol {atol:.3e} = 1e-4 ||M||): "
                  + ", ".join(f"{r} {d:.3e}" for r, d in diffs.items()) + f"; {times} (events, second call)")

    # the library calls the baselines lean on, each timed once after a warm-up call
    gen = torch.Generator(device="cuda").manual_seed(8)
    for n in LINALG_EIGH_SIZES:
        a = torch.randn((n, 2 * n), generator=gen, device="cuda")
        g = a @ a.T
        torch.linalg.eigh(g)
        _, sec, _ = _events(lambda: torch.linalg.eigh(g))
        print(f"phase8 torch.linalg.eigh f32 {n}x{n}: {sec * 1e3:.1f} ms")
    for p, q in LINALG_SVD_SHAPES:
        a = torch.randn((p, q), generator=gen, device="cuda")
        torch.linalg.svd(a, full_matrices=False)
        _, sec, _ = _events(lambda: torch.linalg.svd(a, full_matrices=False))
        print(f"phase8 torch.linalg.svd f32 {p}x{q}: {sec * 1e3:.1f} ms")
    video = torch.randn(KERNEL_SHAPES["video"], generator=gen, device="cuda")
    out, sec, _ = _events(lambda: prox_tnn(video, 1.0))
    _on_card("phase8 prox_tnn", out)
    if out.shape != video.shape or not torch.isfinite(out).all():
        raise AssertionError("phase8 prox_tnn at the video shape: not finite")
    n1, n2, n3 = video.shape
    _, again, _ = _events(lambda: prox_tnn(video, 1.0))
    print(f"phase8 prox_tnn f32 {n1}x{n2}x{n3} (fft, {n3} complex64 svds of {n1}x{n2}, ifft): "
          f"first call {sec * 1e3:.1f} ms, second {again * 1e3:.1f} ms")


def _falling(tag, hist) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    if not (hist.size > 1 and np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError(f"{tag}: err_hist not finite and falling: {hist}")
    return hist


# The gram route's final RRE at taxi, 100 iterations, in float64 on the CPU,
# which the float32 run on the card must land within BASELINE_RRE_TOL of,
# both: the JAX package's (docs/baseline_rre_reference.py), independent of
# the port's code, and the port's own (tools/baseline_reference: ttnn
# 0.3167009, ring 0.3119290, fctn 0.3167008). With torch.linalg.eigh's
# float32 syevj, whose eigenvectors reconstruct a 500 x 500 Gram only to 4e-4
# of its norm (tools/capture_linalg), ring ended at 0.313511, 1.6e-3 from
# either.
BASELINE_RRE_JAX = {"ttnn": 0.3167009, "ring": 0.3119290, "fctn": 0.3167008}
BASELINE_RRE = {"ttnn": 0.316701, "ring": 0.311929, "fctn": 0.316701}
BASELINE_RRE_TOL = 1e-3
# the routes of baselines/device_loop.py compared at 10 iterations, in turns
BASELINE_TURNS = (("graphs", True), ("graphs again", True), ("no graphs", False))
# the baselines whose loop takes the eager loop on the card at taxi: fctn's
# 1000 x 1000 Grams go to Xsyevd, which no graph captures (device_loop.route)
EAGER_BASELINES = ("fctn",)
# a driver of ops/device_linalg.py other than torch.linalg's held to it within
# this many n eps ||A|| (eigenvalues, singular values, reconstructions)
LINALG_EPS_FACTOR = 64


@contextlib.contextmanager
def _loop_syncs():
    """Inside: the synchronizing calls of each baseline loop
    (`baselines/device_loop.run`), from its first iteration to its result,
    counted apart from the rest of the call; yields the list of counts."""
    from tritd_tpu_torch.baselines import device_loop

    counts, real = [], device_loop.run

    def run(*args, **kwargs):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = real(*args, **kwargs)
        counts.append(sum("called a synchronizing" in str(w.message) for w in seen))
        return out

    device_loop.run = run
    try:
        yield counts
    finally:
        device_loop.run = real


def _linalg_calls() -> dict:
    return {k: n for k, n in hopper_kernels.LINALG_CALLS.items() if n}


def _hold_linalg_drivers(y: torch.Tensor) -> None:
    """Each eigh driver ops/device_linalg.py takes at the SVT baselines'
    taxi sizes against torch.linalg on the same matrix (the Grams of the
    taxi tensor's unfoldings, as the loops' first SVTs see them): bitwise
    where it is torch's driver, else within LINALG_EPS_FACTOR n eps ||A||;
    both timed (events around LINALG_REPS calls after one). The SVD's
    driver at these sizes, the Jacobi kernel: `_jacobi_kernel`."""
    from tritd_tpu_torch.ops import device_linalg

    eps = torch.finfo(torch.float32).eps
    unfold = {100: y.reshape(100, -1), 500: y.reshape(-1, 500), 1000: y.reshape(100, 100, 50, 10).permute(
        0, 2, 1, 3).reshape(5000, 1000)}
    for n, m in unfold.items():
        a = m.T @ m if m.shape[0] > m.shape[1] else m @ m.T
        driver = device_linalg.eigh_driver(n, a.dtype)
        (w, v), ours = _linalg_us(lambda: device_linalg.eigh(a))
        (tw, tv), theirs = _linalg_us(lambda: torch.linalg.eigh(a))
        bound = LINALG_EPS_FACTOR * n * eps * float(torch.linalg.matrix_norm(a, 2))
        dw = float((w - tw).abs().max())
        rec = float(torch.linalg.matrix_norm((v * w) @ v.T - a))
        same = torch.equal(w, tw) and torch.equal(v, tv)
        torch_driver = device_linalg.torch_eigh_driver(n, a.dtype)
        if (driver == torch_driver and not same) or dw > bound or rec > bound:
            raise AssertionError(f"phase9 eigh {n}x{n} {driver} (torch's {torch_driver}): bitwise {same}, "
                                 f"max |dlambda| {dw:.3e}, reconstruction {rec:.3e}, bound {bound:.3e}")
        print(f"phase9 eigh f32 {n}x{n} Gram: {driver} {ours:.1f} us, torch.linalg.eigh ({torch_driver}) "
              f"{theirs:.1f} us; bitwise {same}; max |dlambda| {dw:.3e}, reconstruction {rec:.3e} "
              f"(bound {LINALG_EPS_FACTOR} n eps ||A|| {bound:.3e}); {CARD[0]}")


def _linalg_us(call, reps: int = LINALG_REPS) -> tuple:
    """(call(), its µs: CUDA events around `reps` more calls)."""
    out = call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) * 1e3 / reps


# the Jacobi SVD's checks (phase 9), against torch.linalg.svd of the matrix
# in float64, the kernel on the card and its plain version on the CPU each:
# singular values and the reconstruction within JACOBI_LIMITS s_max, both
# sides orthonormal within the rotation test's tolerance sqrt(k) eps plus
# that, each singular vector up to sign where its gap to its neighbours
# exceeds JACOBI_GAP s_max, within JACOBI_LIMITS s_max / gap; the two's
# singular values within twice it of each other (JACOBI_LIMITS: see
# ops/device_linalg.py). torch.linalg.svd (gesvdj, the library call) is
# held within JACOBI_EPS_FACTOR k eps s_max (it reads up to 8.1e-5 on the
# singular values in float32). Timed by events around one call, the median
# of JACOBI_TURNS (torch.linalg.svd's of JACOBI_LIBRARY_TURNS; the plain
# version by the host clock in the CPU pool)
JACOBI_EPS_FACTOR = 64
JACOBI_GAP = 1e-3
JACOBI_TURNS = 5
JACOBI_LIBRARY_TURNS = 3
JACOBI_REPLACES = "tritd_tpu/ops/svt.py:143"  # jnp.linalg.svd in the reference's svd route: no Pallas kernel
JACOBI_HEADLINE = "5000x1000"  # the kernels line's shape: fctn's, the largest thin side


def _taxi_unfoldings(y: torch.Tensor) -> dict:
    """The unfoldings the SVT baselines cut the taxi tensor into, by shape:
    ttnn's and trpca_snn's, ring's, fctn's (its 4-way bipartitions, both
    ways round)."""
    n1, n2, n3 = y.shape
    fctn = y.reshape(n1, n2, n3 // 10, 10).permute(0, 2, 1, 3).reshape(n1 * n3 // 10, n2 * 10)
    mats = [y.reshape(n1, -1), y.reshape(-1, n3), y.permute(2, 0, 1).reshape(n3, -1), y.permute(1, 2, 0).reshape(-1, n1),
            fctn, fctn.T]
    return {"x".join(map(str, m.shape)): m.contiguous() for m in mats}


def _jacobi_bound(p: int, q: int, dtype) -> tuple[float, str]:
    """The least ms an SVD of a p x q matrix could take: reading A once and
    writing U, s and V once, against the flops of one Golub-Kahan
    bidiagonalization, 4 m k^2 - 4 k^3 / 3, at the dtype's peak."""
    k, m = min(p, q), max(p, q)
    size = torch.finfo(dtype).bits // 8
    by_bytes = (p * q + p * k + k + k * q) * size / PEAK_BYTES_PER_S
    by_flops = (4 * m * k * k - 4 * k ** 3 / 3) / PEAK_FLOPS[dtype]
    return max(by_bytes, by_flops) * 1e3, "bytes" if by_bytes >= by_flops else "operations"


def _svd_distance(tag, a, got, ref, bound: float) -> dict:
    """`got` (u, s, vh) of `a` held to `ref`, torch.linalg.svd of `a` in
    float64, within `bound` s_max (the limits above); returns the distances."""
    from tritd_tpu_torch.ops import device_linalg

    k = min(a.shape)
    u, s, vh = (x.double() for x in got)
    ru, rs, rvh = ref
    smax = float(rs[0])
    keep = s > 0
    orth = max(float((b.mT @ b - torch.eye(b.shape[1], dtype=torch.float64, device=b.device)).abs().max())
               for b in (u[:, keep], vh[keep].mT))
    out = {"ds": float((s - rs).abs().max()) / smax,
           "rec": float(torch.linalg.matrix_norm((u * s) @ vh - a.double())) / (smax * k ** 0.5), "orth": orth}
    gaps = torch.minimum(torch.cat([rs.new_tensor([float("inf")]), rs[:-1] - rs[1:]]),
                         torch.cat([rs[:-1] - rs[1:], rs.new_tensor([float("inf")])]))
    vec = 0.0
    for i in torch.nonzero(gaps > JACOBI_GAP * smax).flatten().tolist():
        for mine, theirs in ((u[:, i], ru[:, i]), (vh[i], rvh[i])):
            sign = 1.0 if float(mine @ theirs) >= 0 else -1.0
            vec = max(vec, float((mine - sign * theirs).abs().max()) * float(gaps[i]) / smax)
    out["vectors"] = vec
    limits = {"ds": bound, "rec": bound, "orth": device_linalg.jacobi_tol(k, a.dtype) + bound, "vectors": bound}
    bad = {key: (out[key], limits[key]) for key in limits if not out[key] <= limits[key]}
    if bad:
        raise AssertionError(f"{tag}: beyond its limits against torch.linalg.svd in float64: {bad}")
    return out


def _median_ms(call, turns: int) -> float:
    times = []
    for _ in range(turns):
        _, sec, _ = _events(call)
        times.append(sec * 1e3)
    return statistics.median(times)


def _plain_jacobi(a_np: np.ndarray) -> tuple:
    """In a worker of `_cpu_pool()`: the plain version of the Jacobi SVD
    (`jacobi_svd_torch`) of `a_np` on the CPU in its dtype, held to
    torch.linalg.svd of it in float64 there (`_svd_distance`); (its singular
    values, its distances, its seconds)."""
    from tritd_tpu_torch.ops import device_linalg

    torch.set_num_threads(CPU_REF_THREADS)
    a = torch.from_numpy(a_np)
    t0 = time.perf_counter()
    u, s, vh = device_linalg.jacobi_svd_torch(a)
    seconds = time.perf_counter() - t0
    ref = torch.linalg.svd(a.double(), full_matrices=False)
    label = f"phase9 jacobi_svd_torch[{a.dtype}] {'x'.join(map(str, a.shape))} (CPU)"
    return s.numpy(), _svd_distance(label, a, (u, s, vh), ref, JACOBI_LIMITS[a.dtype]), seconds


def _jacobi_kernel(y: torch.Tensor) -> tuple:
    """The Jacobi SVD kernel (csrc/jacobi_svd.cu) at every taxi unfolding,
    float32 and float64: held to torch.linalg.svd in float64
    (`_svd_distance`), a captured call replayed twice bitwise the eager
    call, timed beside its bound and torch.linalg.svd (gesvdj, the library
    call); its plain version runs on the same inputs in the CPU pool
    (`_plain_jacobi`: 2-28 s a call on the card, longer than this phase),
    once for a matrix and its transpose (three of the six unfoldings are
    the others' transposes; the plain version runs on the tall form).
    Returns the kernels line's records by (name, dtype tag),
    JACOBI_HEADLINE's numbers with every shape's under "shapes", and the
    check that collects the plain version's runs, holds the kernel's
    singular values to theirs and fills in max_abs_err and plain_ms."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    records, pending = {}, []
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        shapes, tall_forms = {}, []
        for name, m in _taxi_unfoldings(y).items():
            a = m.to(dtype)
            p, q = a.shape
            label = f"phase9 jacobi_svd[{tag}] {name}"
            # the plain version runs on the tall form, the same for a matrix and its transpose: one run each
            tall = a if p >= q else a.T
            job = next((job for other, job in tall_forms if torch.equal(other, tall)), None)
            shared = job is not None
            if not shared:
                job = _cpu_pool().submit(_plain_jacobi, tall.contiguous().cpu().numpy())
                tall_forms.append((tall, job))
            pending.append((tag, name, job, shared))
            ref = torch.linalg.svd(a.double(), full_matrices=False)
            u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
            kernel = _svd_distance(label, a, (u, s, vh), ref, JACOBI_LIMITS[dtype])
            if not int(sweeps) < device_linalg.JACOBI_SWEEPS:
                raise AssertionError(f"{label}: stopped at its cap of {int(sweeps)} sweeps unconverged")
            a_call = jacobi_sweeps.kernels_a_call(lambda: device_linalg.jacobi_svd(a))
            if a_call != dict.fromkeys(device_linalg.JACOBI_KERNELS, 1):
                raise AssertionError(f"{label}: a call launched {a_call}, not each of JACOBI_KERNELS once")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                device_linalg.jacobi_svd(a)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                cu, cs, cvh = device_linalg.jacobi_svd(a)
            replays = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                replays.append(torch.equal(cu, u) and torch.equal(cs, s) and torch.equal(cvh, vh))
            del graph, cu, cs, cvh
            if not all(replays):
                raise AssertionError(f"{label}: captured replays bitwise the eager call: {replays}")
            ms = _median_ms(lambda: device_linalg.jacobi_svd(a), JACOBI_TURNS)
            torch.linalg.svd(a, full_matrices=False)
            library_ms = _median_ms(lambda: torch.linalg.svd(a, full_matrices=False), JACOBI_LIBRARY_TURNS)
            torch_f = _svd_distance(f"{label} torch.linalg.svd", a, torch.linalg.svd(a, full_matrices=False), ref,
                                    JACOBI_EPS_FACTOR * min(p, q) * torch.finfo(dtype).eps)
            bound_ms, bound_by = _jacobi_bound(p, q, dtype)
            shapes[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                            "sweeps": int(sweeps), "launches_a_call": sum(a_call.values()), "s": s.cpu().numpy(),
                            "limit": 2 * JACOBI_LIMITS[dtype] * float(ref[1][0])}
            print(f"{label}: {int(sweeps)} sweeps, {sum(a_call.values())} launches a call; "
                  f"kernel {ms:.3f} ms, torch.linalg.svd (gesvdj) {library_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} (events); against torch.linalg.svd in float64 (ds/s_max, "
                  f"rec/(s_max sqrt k), orth, vectors x gap/s_max): kernel {_fmt(kernel)}, torch {_fmt(torch_f)}; "
                  f"captured replays bitwise {replays}; {CARD[0]}", flush=True)
        records["jacobi_svd", tag] = {"shape": JACOBI_HEADLINE, "shapes": shapes}
        del tall_forms

    def check() -> None:
        for tag, name, future, shared in pending:
            plain_s, plain, seconds = future.result()
            row = records["jacobi_svd", tag]["shapes"][name]
            max_abs = float(np.max(np.abs(row.pop("s").astype(np.float64) - plain_s)))
            limit = row.pop("limit")
            if not max_abs <= limit:
                raise AssertionError(f"phase9 jacobi_svd[{tag}] {name}: singular values {max_abs:.3e} from the plain "
                                     f"version's, limit {limit:.3e}")
            row.update(max_abs_err=max_abs, plain_ms=seconds * 1e3, plain_device="cpu")
            print(f"phase9 jacobi_svd[{tag}] {name}: |s - plain s| {max_abs:.3e} (limit {limit:.3e}); plain version "
                  f"on the CPU ({CPU_REF_THREADS} threads) {seconds:.1f} s"
                  + (" (its run on the transpose, the same tall form)" if shared else "")
                  + f", against torch.linalg.svd in float64 {_fmt(plain)}", flush=True)
        for tag in ("f32", "f64"):
            record = records["jacobi_svd", tag]
            record.update({key: value for key, value in record["shapes"][JACOBI_HEADLINE].items()})

    return records, check


def _fmt(d: dict) -> str:
    return "{" + ", ".join(f"{k} {v:.2e}" for k, v in d.items()) + "}"


def _jacobi_spectra() -> None:
    """The kernel's sweeps on the spectra its cap was set from
    (`tools/jacobi_sweeps`: graded, clustered and rank-deficient at
    5000 x 1000, the tall form that took the most sweeps, and standard
    normal 5000 x 1000 and 5000 x 1024; `tools/jacobi_sweeps --device cuda`
    reads every case), float32 and float64: each converged under
    JACOBI_SWEEPS, its singular values within JACOBI_LIMITS s_max of
    torch.linalg.svd's in float64."""
    from tritd_tpu_torch.tools import jacobi_sweeps

    t0 = time.perf_counter()
    matrices = jacobi_sweeps.cases(("graded", "clustered", "rank-def", "thin"), shapes=((5000, 1000),))
    made = time.perf_counter() - t0
    for record in jacobi_sweeps.measure(matrices, (torch.float32, torch.float64), "cuda"):
        dtype = getattr(torch, record["dtype"])
        if not record["converged"] or record["ds_over_smax"] > JACOBI_LIMITS[dtype]:
            raise AssertionError(f"phase9 jacobi_svd on {record['case']} {record['dtype']}: {record}")
        print(f"phase9 jacobi_svd[{record['dtype']}] {record['case']}: {record['sweeps']} sweeps (cap "
              f"{record['cap']}), |ds|/s_max {record['ds_over_smax']:.2e}, {record['seconds'] * 1e3:.1f} ms a call "
              f"with its read of the sweeps; {CARD[0]}", flush=True)
    print(f"phase9 jacobi_svd spectra: matrices made on the host in {made:.1f} s", flush=True)


def _eager_row(method: str, svt_method: str) -> bool:
    """Whether a baseline row takes the eager loop on the card at taxi:
    fctn's eighs of its 1000 x 1000 Grams (gram, warm:8) go to Xsyevd, which
    no graph captures; its svd route's SVDs are the Jacobi kernel's."""
    return method in EAGER_BASELINES and svt_method != "svd"


def _baseline_routes(method: str, svt_method: str, solve) -> None:
    """At 10 iterations: the graph route twice and the device form without
    graphs, bitwise; captures and synchronizing calls of each. A row that
    takes the eager loop (`_eager_row`) takes it where graphs would run:
    those two turns bitwise, the device form within rtol 1e-4 of their
    err_hist (it divides by the penalties on the card, the eager loop by
    host floats)."""
    from tritd_tpu_torch.ops import toolbox_loop

    runs = {}
    for label, graphs in BASELINE_TURNS:
        with toolbox_loop.forced_route(graphs):
            runs[label] = solve(method, 10, svt_method)
    ref = runs["graphs"]["out"]
    eager = _eager_row(method, svt_method)
    held = [label for label, graphs in BASELINE_TURNS if graphs or not eager]
    differ = [label for label in held if not all(_same_bits(a, b) for a, b in zip(runs[label]["out"], ref))]
    if differ:
        raise AssertionError(f"phase9 {method} {svt_method}, 10 iterations: {differ} not bitwise the first")
    if eager:
        np.testing.assert_allclose(runs["no graphs"]["hist"], runs["graphs"]["hist"], rtol=1e-4)
    route = "eager loop" if eager else "graph route"
    print(f"phase9 {method} {svt_method} 10 iterations: {route}, {route} again "
          + ("bitwise, no graphs within rtol 1e-4; " if eager else "and no graphs bitwise; ")
          + "; ".join(f"{label} {r['ms'] / 10:.3f} ms/iter, {r['graphs']} captures, loop syncs {r['loop_syncs']}"
                      for label, r in runs.items()))


def phase9() -> tuple:
    """The baselines at the full taxi shape, through the CLI's dispatch, on
    the graph route of baselines/device_loop.py (fctn's gram and warm:8 on
    the eager loop, `_eager_row`); before them the Jacobi SVD kernel at the
    taxi unfoldings (`_jacobi_kernel`); after them SOFIA's kernels against
    their plain versions (`_sofia_kernels`). Returns the kernels line's
    records of both by (name, dtype tag), the Jacobi kernel's launches on
    the main path (the svd rows' 100 iterations) and the check of its plain
    version's runs in the CPU pool."""
    from tritd_tpu_torch.baselines.rtrc import precompute_freedom_ratio
    from tritd_tpu_torch.cli.run_completion import run_method
    from tritd_tpu_torch.ops import device_linalg

    x, mask, y, prov = _taxi()
    _x_np, spec, _prov = load_dataset("taxi")
    shape = "x".join(map(str, x.shape))

    def solve(method, max_iter, svt_method):
        gen = torch.Generator().manual_seed(0)
        hopper_kernels.reset_launch_counts()
        capped = device_linalg.jacobi_capped(y.device)
        capped.zero_()
        with _loop_syncs() as loop_syncs:
            w = _watched(lambda: run_method(method, y, x, mask, spec, gen, max_iter, svt_method=svt_method))
        if int(capped):
            raise AssertionError(f"phase9 {method} {svt_method}: {int(capped)} Jacobi SVDs stopped at their cap")
        x_hat, o, hist = w["res"]
        _on_card(f"phase9 {method} {svt_method}", x_hat, o)
        if x_hat.shape != x.shape or not torch.isfinite(x_hat).all():
            raise AssertionError(f"phase9 {method} {svt_method}: X not finite at the input's shape")
        return {"rre": float(rre(x_hat, x)), "hist": np.asarray(hist, dtype=np.float64), "out": (x_hat, o),
                "loop_syncs": loop_syncs, "calls": _linalg_calls(),
                "jacobi": dict(hopper_kernels.JACOBI_SVD_LAUNCHES), **w}

    _hold_linalg_drivers(y)
    records, jacobi_check = _jacobi_kernel(y)
    _jacobi_spectra()
    # ring's host float64 ranks, once: the solves below find them cached
    t0 = time.perf_counter()
    precompute_freedom_ratio(y, mask)
    print(f"phase9 ring freedom ratio (host float64 matrix_rank of 10000x500 and 50000x100): "
          f"{time.perf_counter() - t0:.2f} s")
    final, main_launches = {}, {}
    for method in ("ttnn", "ring", "fctn"):
        for svt_method in ("svd", "gram", "warm:8"):
            run = solve(method, 100, svt_method)
            hist = run["hist"]
            if _falling(f"phase9 {method} {svt_method}", hist).shape != (100,):
                raise AssertionError(f"phase9 {method} {svt_method}: {hist.shape[0]} iterations")
            eager = _eager_row(method, svt_method)
            if eager:  # Xsyevd reads back inside each call: the eager loop, no capture
                if run["graphs"] or not run["calls"].get("xsyevd[f32]"):
                    raise AssertionError(f"phase9 {method} {svt_method}: {run['graphs']} captures (want 0, the "
                                         f"eager loop), binding calls {run['calls']} (want xsyevd's)")
            else:
                segments = 4 if method == "fctn" and svt_method == "warm:8" else 1
                captures = 2 if svt_method == "warm:8" else 1
                calls = run["jacobi"]["jacobi_svd[f32]"] if svt_method == "svd" else sum(run["calls"].values())
                if run["graphs"] != captures or run["loop_syncs"] != [segments] or not calls:
                    raise AssertionError(f"phase9 {method} {svt_method}: {run['graphs']} captures (want {captures}), "
                                         f"loop syncs {run['loop_syncs']} (want [{segments}]), binding calls "
                                         f"{run['calls']}, Jacobi launches {run['jacobi']}")
            if svt_method == "svd":
                if run["calls"]:  # every SVD of the row is the kernel's: no gesvdj, no eigh
                    raise AssertionError(f"phase9 {method} svd: binding calls {run['calls']} beside the kernel's")
                for key, n in run["jacobi"].items():
                    main_launches[key] = main_launches.get(key, 0) + n
                svd_hist = hist
            if svt_method in ("svd", "gram"):
                final[method, svt_method] = run["rre"]
                wants = (("JAX package's", BASELINE_RRE_JAX),) + ((("port's", BASELINE_RRE),) if svt_method == "gram"
                                                                  else ())
                for what, want in wants:
                    if abs(run["rre"] - want[method]) > BASELINE_RRE_TOL:
                        raise AssertionError(f"phase9 {method} {svt_method} RRE {run['rre']} against the {what} "
                                             f"float64 gram run's {want[method]}, beyond {BASELINE_RRE_TOL}")
            if svt_method == "gram":  # within rtol 1e-3 of the svd row over the first 10 iterations
                np.testing.assert_allclose(hist[:10], svd_hist[:10], rtol=1e-3)
            elif svt_method == "warm:8":
                if method == "fctn" and abs(run["rre"] - final["fctn", "gram"]) > 1e-3:
                    raise AssertionError(f"phase9 fctn warm:8 RRE {run['rre']} vs gram {final['fctn', 'gram']}, "
                                         f"beyond 1e-3")
                print(f"phase9 {method} warm:8 RRE {run['rre']:.6f} vs gram {final[method, 'gram']:.6f}: |diff| "
                      f"{abs(run['rre'] - final[method, 'gram']):.2e}")
            print(f"phase9 {method} taxi ({prov}) {shape} 10% missing f32 {svt_method}: iters=100 "
                  f"{'eager loop' if eager else 'graph route'} "
                  f"{run['ms']:.1f} ms (events) {run['ms'] / 100:.3f} ms/iter, first replay after "
                  f"{run.get('before_replays_ms', float('nan')):.1f} ms ({run.get('capture_host_ms', float('nan')):.1f}"
                  f" ms of capture host time), replays {run.get('replays_ms', float('nan')) / 99:.3f} ms/iter; "
                  f"captures {run['graphs']}; syncs in the loop {run['loop_syncs']}, outside it {run['syncs']}; "
                  f"peak_mem={run['peak_mib']:.1f} MiB; binding calls {run['calls']}; Jacobi launches "
                  f"{ {k: n for k, n in run['jacobi'].items() if n} }; rre={run['rre']:.6f} (float64 CPU gram "
                  f"runs: JAX {BASELINE_RRE_JAX[method]}, port {BASELINE_RRE[method]}) err[0]={hist[0]:.4e} "
                  f"err[-1]={hist[-1]:.4e}"
                  + (f"; max rel diff to the svd row over 10 iterations "
                     f"{np.max(np.abs(hist[:10] - svd_hist[:10]) / svd_hist[:10]):.2e} (rtol 1e-3)"
                     if svt_method == "gram" else "") + f"; {CARD[0]}", flush=True)
            _baseline_routes(method, svt_method, solve)
    # sofia's error against the truth need not fall: the outlier peel anneals
    sofia = solve("sofia", 10, "svd")
    hist = sofia["hist"]
    if not (hist.size and np.isfinite(hist).all() and sofia["rre"] < 1.0):
        raise AssertionError(f"phase9 sofia: rre {sofia['rre']}, err_hist {hist}")
    print(f"phase9 sofia taxi r=3 m={spec.sofia_period}: epochs={hist.shape[0]} solve={sofia['ms'] / 1e3:.3f} s "
          f"(events) peak_mem={sofia['peak_mib']:.1f} MiB rre={sofia['rre']:.6f} err[0]={hist[0]:.4e} "
          f"err[-1]={hist[-1]:.4e}")
    return {**records, **_sofia_kernels()}, main_launches, jacobi_check


def phase10() -> dict:
    """RC-FCTN's video protocol at full width, trpca_snn at taxi on both
    device routes (`_trpca_snn_routes`, whose Jacobi launches it returns),
    and the two other baselines off the CLI's path at small shapes."""
    from tritd_tpu_torch.baselines import fctn_compose, rc_fctn_driver_video, rnc_fctn, trpca_tnn
    from tritd_tpu_torch.baselines.rc_fctn import resolve_video_svt_method
    from tritd_tpu_torch.ops import toolbox_loop
    from tritd_tpu_torch.ops.svt import auto_method

    v_np, vspec, vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    n4 = v.shape[2] // vspec.fctn_subdim
    cuts = ((v.shape[0] * v.shape[1], v.shape[2]), (v.shape[0] * vspec.fctn_subdim, v.shape[1] * n4),
            (v.shape[0] * n4, v.shape[1] * vspec.fctn_subdim))
    route = resolve_video_svt_method("auto")
    routes = [auto_method(p, q, int(route.partition(":")[2])) for p, q in cuts]
    if route != "auto:512" or routes != ["gram", "lowrank:512", "lowrank:512"]:
        raise AssertionError(f"phase10: the video driver's default resolves to {route}, cuts {cuts} to {routes}")
    runs = {}
    for label, graphs in (("graphs", True), ("no graphs", False)):
        hopper_kernels.reset_launch_counts()
        with toolbox_loop.forced_route(graphs), _loop_syncs() as loop_syncs:
            w = _watched(lambda: rc_fctn_driver_video(v, torch.ones_like(v, dtype=torch.bool), vspec.fctn_subdim,
                                                      origin=v, max_iter=10))
        runs[label] = {**w, "loop_syncs": loop_syncs, "calls": _linalg_calls()}
        _release_cached()
    graph, plain = runs["graphs"], runs["no graphs"]
    x_hat, sparse, hist = graph["res"]
    _on_card("phase10 fctn video", x_hat, sparse, hist)
    hist = _falling("phase10 fctn video", hist.cpu().numpy())
    if x_hat.shape != v.shape or not torch.isfinite(x_hat).all():
        raise AssertionError("phase10 fctn video: X not finite at the input's shape")
    same = all(_same_bits(a, b) for a, b in zip(graph["res"], plain["res"]))
    if not same or graph["graphs"] != 1 or graph["loop_syncs"] != [1] or not graph["calls"]:
        raise AssertionError(f"phase10 fctn video: graph route bitwise the route without graphs {same}, "
                             f"captures {graph['graphs']}, loop syncs {graph['loop_syncs']}, binding calls "
                             f"{graph['calls']}")
    print(f"phase10 fctn video highway ({vprov}) {'x'.join(map(str, v.shape))} f32 {route} "
          f"({', '.join(f'{p}x{q} {r}' for (p, q), r in zip(cuts, routes))}): iters=10, graph route "
          f"{graph['ms'] / 10:.1f} ms/iter (first replay after {graph.get('before_replays_ms', float('nan')):.1f} ms, "
          f"replays {graph.get('replays_ms', float('nan')) / 9:.1f} ms/iter), no graphs {plain['ms'] / 10:.1f} "
          f"ms/iter, bitwise; captures {graph['graphs']}; syncs in the loop {graph['loop_syncs']}, outside it "
          f"{graph['syncs']}; peak_mem={graph['peak_mib']:.1f} / {plain['peak_mib']:.1f} MiB; binding calls "
          f"{graph['calls']}; err[0]={hist[0]:.4e} err[-1]={hist[-1]:.4e}; {CARD[0]}")
    del x_hat, sparse, runs, graph, plain

    launches = _trpca_snn_routes()

    slab = v[:64, :64, :32].contiguous()
    (low, sp, hist), sec, _ = _events(lambda: trpca_tnn(slab, origin=slab, mu=1e-3, max_iter=20))
    _on_card("phase10 trpca_tnn", low, sp, hist)
    hist = _falling("phase10 trpca_tnn", hist.cpu().numpy())
    print(f"phase10 trpca_tnn 64x64x32 slab: iters=20 solve={sec:.3f} s (events) "
          f"err[0]={hist[0]:.4e} err[-1]={hist[-1]:.4e}")

    gen = torch.Generator().manual_seed(10)
    cores = [torch.rand(shape, generator=gen) for shape in ((16, 2, 2, 2), (2, 16, 2, 2), (2, 2, 8, 2), (2, 2, 2, 8))]
    truth = fctn_compose([c.cuda() for c in cores])
    omega = (torch.rand(truth.shape, generator=gen) > 0.2).cuda()
    data = torch.where(omega, truth, torch.zeros_like(truth))
    (x4, gs, e4, hist, n_it), sec, _ = _events(
        lambda: rnc_fctn(data, 0.1, omega, origin=truth, max_iter=20, generator=torch.Generator().manual_seed(0)))
    _on_card("phase10 rnc_fctn", x4, e4, *gs)
    hist = _falling("phase10 rnc_fctn", hist)
    print(f"phase10 rnc_fctn 16x16x8x8, 20% missing: iters={n_it} solve={sec:.3f} s (events) "
          f"err[0]={hist[0]:.4e} err[-1]={hist[-1]:.4e}")
    return launches


#: Phase 26: the video svd rows' depth cut (the CLI runs 100 iterations),
#: and how far each row may be from the port's float64 CPU run of as many:
#: X's Frobenius distance over the CPU run's norm within VIDEO_SVD_X_RTOL
#: (readings 1.9e-6 to 3.1e-6), and the RRE and each entry of err_hist
#: within VIDEO_SVD_ATOL + VIDEO_SVD_RTOL times the CPU run's (readings:
#: relative up to 2.2e-6 on ring highway, absolute up to 1.2e-7 on ring's
#: static clip, whose RRE of 2.9e-5 is a few float32 roundings of X from
#: its value; `_hist_diff`). Each limit is about 10 times its largest
#: reading (PERF.md section 5).
VIDEO_SVD_ITERS = 5
VIDEO_SVD_X_RTOL = 3e-5
VIDEO_SVD_RTOL = 2e-5
VIDEO_SVD_ATOL = 1e-6
VIDEO_SVD_METHODS = ("ttnn", "ring")


def _video_clips() -> tuple:
    """The highway stand-in (240 x 320 x 300) and its static clip, frame 0
    repeated in every frame (made here, nothing fetched): {name: float32
    numpy}, the spec and the provenance."""
    v_np, vspec, vprov = load_dataset("highway")
    v_np = v_np.astype(np.float32)
    static = np.ascontiguousarray(np.repeat(v_np[:, :, :1], v_np.shape[2], axis=2))
    return {"highway": v_np, "static": static}, vspec, vprov


def _video_svd_cpu(method: str, x32: np.ndarray, spec, iters: int) -> tuple:
    """In a worker of `_cpu_pool()`: (RRE, err_hist, X, seconds) of the
    port's float64 run of `method` on the CPU through `cli/run_video.solve`, the
    svd route (torch.linalg.svd), nothing missing; ring's freedom ratio
    the card run's, from the float32 data (numpy's float32 matrix_rank
    counts other ranks than float64's, and so other weights)."""
    import importlib

    from tritd_tpu_torch.cli.run_video import solve

    rtrc = importlib.import_module("tritd_tpu_torch.baselines.rtrc")  # the module (the package exports the function)
    torch.set_num_threads(CPU_REF_THREADS)
    x = torch.from_numpy(x32).double()
    mask = torch.ones(x.shape, dtype=torch.bool)
    if method == "ring":
        p = mask.to(x.dtype)
        rtrc._FREEDOM_RATIO_CACHE[rtrc._fingerprint(x * p, p)] = rtrc.freedom_ratio(
            torch.from_numpy(x32) * p.float(), p.float(), use_cache=False)
    t0 = time.perf_counter()
    x_hat, _o, hist = solve(method, x, x, mask, spec, 0, iters, svt_method="svd")
    return float(rre(x_hat, x)), np.asarray(hist, dtype=np.float64), x_hat.numpy(), time.perf_counter() - t0


def _exact_families() -> None:
    """The kernel on the exact families (tools/jacobi_sweeps.EXACT_SMALL),
    float32 and float64, and on zero columns among standard normal ones at
    the video cut's tall forms (VIDEO_TALL_FORMS, seed 0), float32, where a
    rotation test's tolerance growing as sqrt(m) stopped the sweeps 5e-6
    s_max off: converged within LAPACK_SWEEPS, jacobi_capped 0, held to
    torch.linalg.svd in float64 and to its plain version (the same values
    zero; on the CPU, at the video forms on the card, where it takes a few
    seconds); each eager call returns."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    both = ((torch.float32, "f32"), (torch.float64, "f64"))

    def cases():  # (name, matrix, dtypes, where the plain version runs), made one at a time
        for name in jacobi_sweeps.EXACT_SMALL:
            yield f"exact {name}", jacobi_sweeps.exact_small(name), both, "cpu"
        for m, k in jacobi_sweeps.VIDEO_TALL_FORMS:
            yield f"zero-cols {m}x{k}", jacobi_sweeps.exact_matrix("zero-cols", m, k, np.random.default_rng(0)), \
                both[:1], "cuda"

    capped = device_linalg.jacobi_capped("cuda")
    for name, a_np, dtypes, plain_on in cases():
        for dtype, tag in dtypes:
            a = torch.from_numpy(a_np).to(dtype).cuda()
            label = f"phase26 jacobi_svd[{tag}] {name}"
            capped.zero_()
            u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
            ref = torch.linalg.svd(a.double(), full_matrices=False)
            got = _svd_distance(label, a, (u, s, vh), ref, JACOBI_LIMITS[dtype])
            eu, es, evh = device_linalg.jacobi_svd(a)  # eager: reads its flag, raises at the cap
            pu, ps, pvh, plain_sweeps = device_linalg._jacobi_torch(a.to(plain_on))
            ps = ps.to(s.device)
            ds = float((s.double() - ps.double()).abs().max())
            limit = 2 * JACOBI_LIMITS[dtype] * float(ref[1][0])
            if not (int(sweeps) <= LAPACK_SWEEPS and plain_sweeps <= LAPACK_SWEEPS and int(capped) == 0
                    and ds <= limit and torch.equal(s == 0, ps == 0) and torch.equal(es, s)):
                raise AssertionError(f"{label}: sweeps {int(sweeps)} (plain {plain_sweeps}), capped {int(capped)}, "
                                     f"|s - plain s| {ds:.2e} (limit {limit:.2e}), zeros {int((s == 0).sum())} / "
                                     f"{int((ps == 0).sum())}, eager bitwise {torch.equal(es, s)}")
            print(f"{label}: {int(sweeps)} sweeps (plain {plain_sweeps}, on {plain_on}), capped 0, eager "
                  f"call returned; against torch.linalg.svd in float64 {_fmt(got)}; |s - plain s| {ds:.2e}; values "
                  f"zero {int((s == 0).sum())} of {s.numel()}", flush=True)
            del a, u, s, vh, ref, eu, es, evh, pu, ps, pvh


def _video_unfoldings(clips: dict) -> None:
    """The kernel at the video cut's three unfoldings of each clip, float32:
    its plan, sweeps, ms a call (events, median of 3) against
    torch.linalg.svd (gesvdj) and held to torch.linalg.svd in float64."""
    from tritd_tpu_torch.ops import device_linalg

    capped = device_linalg.jacobi_capped("cuda")
    index = torch.cuda.current_device()
    for clip, c_np in clips.items():
        c = torch.from_numpy(c_np).cuda()
        mats = (c.reshape(c.shape[0], -1), c.reshape(-1, c.shape[2]), c.permute(1, 2, 0).reshape(-1, c.shape[0]))
        for m in mats:
            a = m.contiguous()
            p, q = a.shape
            label = f"phase26 jacobi_svd[f32] {clip} {p}x{q}"
            capped.zero_()
            u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
            ref = torch.linalg.svd(a.double(), full_matrices=False)
            got = _svd_distance(label, a, (u, s, vh), ref, JACOBI_LIMITS[torch.float32])
            if int(capped) or not int(sweeps) < device_linalg.JACOBI_SWEEPS:
                raise AssertionError(f"{label}: {int(sweeps)} sweeps, capped {int(capped)}")
            plan = device_linalg._plan(index, p, q, torch.float32)
            ms = _median_ms(lambda: device_linalg.jacobi_svd(a), 3)
            torch.linalg.svd(a, full_matrices=False)
            library_ms = _median_ms(lambda: torch.linalg.svd(a, full_matrices=False), 1)
            bound_ms, bound_by = _jacobi_bound(p, q, torch.float32)
            print(f"{label}: plan m={plan.m} k={plan.k} {plan.clusters} clusters of {plan.cluster} CTAs, teams of "
                  f"{plan.team}, {plan.stages} stage(s) of {plan.chunk} tiles, {plan.smem} B; {int(sweeps)} sweeps; "
                  f"kernel {ms:.3f} ms, torch.linalg.svd (gesvdj) {library_ms:.3f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} (events); values zero {int((s == 0).sum())} of {s.numel()}; against "
                  f"torch.linalg.svd in float64 {_fmt(got)}; {CARD[0]}", flush=True)
            del u, s, vh, ref
        del c, mats, a


def phase26() -> tuple:
    """The Jacobi SVD on the exact families and at the video unfoldings,
    then the video protocol's ttnn and ring on the svd route at full width
    on the highway stand-in and its static clip (see the module's
    docstring). Returns the svd rows' Jacobi launches by key and the check
    that holds their RREs to the float64 CPU runs."""
    from tritd_tpu_torch.baselines.rtrc import precompute_freedom_ratio
    from tritd_tpu_torch.cli.run_video import solve
    from tritd_tpu_torch.ops import device_linalg

    clips, vspec, vprov = _video_clips()
    pending = {(method, clip): _cpu_pool().submit(_video_svd_cpu, method, x_np, vspec, VIDEO_SVD_ITERS)
               for clip, x_np in clips.items() for method in VIDEO_SVD_METHODS}
    _exact_families()
    _video_unfoldings(clips)
    launches, rows = {}, {}
    capped = device_linalg.jacobi_capped("cuda")
    for clip, x_np in clips.items():
        x = torch.from_numpy(x_np).cuda()
        mask = torch.ones(x.shape, dtype=torch.bool, device="cuda")
        t0 = time.perf_counter()
        precompute_freedom_ratio(x, mask)
        ranks_s = time.perf_counter() - t0
        for method in VIDEO_SVD_METHODS:
            label = f"phase26 {method} video {clip} svd"
            hopper_kernels.reset_launch_counts()
            capped.zero_()
            with _loop_syncs() as loop_syncs:
                w = _watched(lambda: solve(method, x, x, mask, vspec, 0, VIDEO_SVD_ITERS, svt_method="svd"))
            x_hat, o, hist = w["res"]
            calls, jacobi = _linalg_calls(), dict(hopper_kernels.JACOBI_SVD_LAUNCHES)
            _on_card(label, x_hat, o)
            if x_hat.shape != x.shape or not torch.isfinite(x_hat).all() or not np.isfinite(hist).all():
                raise AssertionError(f"{label}: X or err_hist not finite at the input's shape")
            if (int(capped) or w["graphs"] != 1 or loop_syncs != [1] or calls or not jacobi.get("jacobi_svd[f32]")
                    or len(hist) != VIDEO_SVD_ITERS):
                raise AssertionError(f"{label}: capped {int(capped)}, captures {w['graphs']} (want 1), loop syncs "
                                     f"{loop_syncs} (want [1]), binding calls {calls} (want none), Jacobi launches "
                                     f"{jacobi}, {len(hist)} iterations")
            for key, n in jacobi.items():
                launches[key] = launches.get(key, 0) + n
            rows[method, clip] = float(rre(x_hat, x)), np.asarray(hist, dtype=np.float64), x_hat.cpu().numpy()
            print(f"{label} ({vprov}) {'x'.join(map(str, x.shape))} f32: iters={VIDEO_SVD_ITERS} (the CLI's 100 cut) "
                  f"graph route {w['ms'] / VIDEO_SVD_ITERS:.1f} ms/iter (events; first replay after "
                  f"{w.get('before_replays_ms', float('nan')):.1f} ms, replays "
                  f"{w.get('replays_ms', float('nan')) / (VIDEO_SVD_ITERS - 1):.1f} ms/iter); captures {w['graphs']}; "
                  f"syncs in the loop {loop_syncs}, outside it {w['syncs']}; peak_mem={w['peak_mib']:.1f} MiB; "
                  f"Jacobi launches {jacobi['jacobi_svd[f32]']}, binding calls none, capped 0; ring's host float64 "
                  f"ranks {ranks_s:.2f} s; rre={rows[method, clip][0]:.6f} err[0]={hist[0]:.4e} err[-1]={hist[-1]:.4e}; "
                  f"{CARD[0]}", flush=True)
            del x_hat, o, w
            _release_cached()
        del x, mask

    def check() -> None:
        for (method, clip), future in pending.items():
            label = f"phase26 {method} video {clip} svd"
            want, want_hist, want_x, seconds = future.result()
            got, got_hist, got_x = rows[method, clip]
            dx = float(np.linalg.norm(got_x - want_x) / np.linalg.norm(want_x))
            if not dx <= VIDEO_SVD_X_RTOL:
                raise AssertionError(f"{label}: X at {dx:.3e} of the port's float64 CPU run's norm from it, beyond "
                                     f"{VIDEO_SVD_X_RTOL}")
            text = _hist_diff(f"{label} RRE and err_hist", [got, *got_hist], [want, *want_hist],
                              VIDEO_SVD_ITERS + 1, VIDEO_SVD_RTOL, VIDEO_SVD_ATOL)
            print(f"{label}: RRE {got:.8f}, the port's float64 CPU run of {VIDEO_SVD_ITERS} iterations {want:.8f} "
                  f"({CPU_REF_THREADS} threads, {seconds:.1f} s); X's distance over its norm {dx:.3e} (limit "
                  f"{VIDEO_SVD_X_RTOL}); RRE and err_hist: {text} (rtol {VIDEO_SVD_RTOL}, atol {VIDEO_SVD_ATOL})",
                  flush=True)

    return launches, check


# trpca_snn at taxi (phase 10): iterations of each float32 route, and of the
# float64 graph-route run whose launches are the kernels line's float64 ones
SNN_ITERS = 20
SNN_F64_ITERS = 5
SNN_MU = 1e-3  # the reference's default 1e-4 leaves L zero for the first iterations at taxi's scale


def _trpca_snn_routes() -> dict:
    """trpca_snn at the taxi stand-in (its unfoldings 100x50000 twice and
    500x10000, the svd SVT): float32 on the graph route and the device form
    without graphs, bitwise, one capture, one synchronizing call in the
    loop, every SVD the Jacobi kernel's; float64 on the graph route. Returns
    the Jacobi kernel's launches of the graph-route runs (the main path)."""
    from tritd_tpu_torch.baselines import trpca_snn
    from tritd_tpu_torch.ops import device_linalg, toolbox_loop

    _x, _mask, y, _prov = _taxi()
    runs, launches = {}, {}
    capped = device_linalg.jacobi_capped(y.device)
    for label, graphs, dtype, iters in (("graphs", True, torch.float32, SNN_ITERS),
                                        ("no graphs", False, torch.float32, SNN_ITERS),
                                        ("graphs f64", True, torch.float64, SNN_F64_ITERS)):
        hopper_kernels.reset_launch_counts()
        capped.zero_()
        with toolbox_loop.forced_route(graphs), _loop_syncs() as loop_syncs:
            w = _watched(lambda: trpca_snn(y.to(dtype), mu=SNN_MU, max_iter=iters))
        if int(capped):
            raise AssertionError(f"phase10 trpca_snn {label}: {int(capped)} Jacobi SVDs stopped at their cap")
        runs[label] = {**w, "loop_syncs": loop_syncs, "calls": _linalg_calls(),
                       "jacobi": {k: n for k, n in hopper_kernels.JACOBI_SVD_LAUNCHES.items() if n}}
        if graphs:
            for key, n in runs[label]["jacobi"].items():
                launches[key] = launches.get(key, 0) + n
        low, e, hist = w["res"]
        _on_card(f"phase10 trpca_snn {label}", low, e, hist)
        hist = hist.cpu().numpy()
        if not (np.isfinite(hist).all() and torch.isfinite(low).all() and hist.shape == (iters,)):
            raise AssertionError(f"phase10 trpca_snn {label}: not finite: err_hist {hist}")
        if (runs[label]["calls"] or not runs[label]["jacobi"] or w["graphs"] != (1 if graphs else 0)
                or loop_syncs != [1]):
            raise AssertionError(f"phase10 trpca_snn {label}: captures {w['graphs']}, loop syncs {loop_syncs}, "
                                 f"binding calls {runs[label]['calls']}, Jacobi launches {runs[label]['jacobi']}")
        _release_cached()
    same = all(_same_bits(a, b) for a, b in zip(runs["graphs"]["res"], runs["no graphs"]["res"]))
    if not same:
        raise AssertionError("phase10 trpca_snn taxi f32: the graph route is not bitwise the device form without graphs")
    hist = runs["graphs"]["res"][2].cpu().numpy()
    print(f"phase10 trpca_snn taxi {'x'.join(map(str, y.shape))} f32 mu={SNN_MU}: iters={SNN_ITERS}, graph route "
          f"{runs['graphs']['ms'] / SNN_ITERS:.2f} ms/iter (first replay after "
          f"{runs['graphs'].get('before_replays_ms', float('nan')):.1f} ms, replays "
          f"{runs['graphs'].get('replays_ms', float('nan')) / (SNN_ITERS - 1):.2f} ms/iter), no graphs "
          f"{runs['no graphs']['ms'] / SNN_ITERS:.2f} ms/iter, bitwise; Jacobi launches {runs['graphs']['jacobi']}; "
          f"peak_mem={runs['graphs']['peak_mib']:.1f} MiB; err[0]={hist[0]:.4e} err[-1]={hist[-1]:.4e}; f64 graph "
          f"route {SNN_F64_ITERS} iterations {runs['graphs f64']['ms'] / SNN_F64_ITERS:.2f} ms/iter, Jacobi launches "
          f"{runs['graphs f64']['jacobi']}; {CARD[0]}", flush=True)
    return launches


def phase11() -> None:
    """The completion CLI in this process: TriTD beside three baselines."""
    from tritd_tpu_torch.cli import run_completion

    methods = ["triple", "ttnn", "ring", "fctn"]
    hopper_kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        rows = run_completion.main(["--datasets", "taxi", "--methods", *methods, "--svt-method", "gram",
                                    "--missing-ratio", "0.10", "--out-dir", out])
        for row in rows:
            with np.load(os.path.join(out, f"taxi_{row['method']}_errHist.npz")) as f:
                if f["errHist"].shape != (row["iters"],) or not np.isfinite(f["errHist"]).all():
                    raise AssertionError(f"phase11 artifact of {row['method']}: {f['errHist'].shape}")
    launches = _launches()
    bad = [r for r in rows if not (r["device"] == "cuda" and r["dataset"] == "taxi" and 0.0 < r["rre"] < 1.0
                                   and r.get("svt_method") == (None if r["method"] == "triple" else "gram"))]
    if [r["method"] for r in rows] != methods or bad or launches != {"f32": rows[0]["iters"]}:
        raise AssertionError(f"phase11 cli rows: {rows}; launches {launches}")
    print(f"phase11 cli: {len(rows)} rows on cuda, seconds "
          + ", ".join(f"{r['method']} {r['seconds']}" for r in rows) + f"; kernel launches {launches}")


def _budget_words(shape, rank: int, mode: int) -> int:
    """Design budget of one sharded iteration's all_reduce traffic: the
    sharded core's Gram (r^4), the two reduced right-hand sides and the
    residual sums, with room for one more r^4 and a few scalars."""
    n1, n2, n3 = shape
    r2 = rank * rank
    return 2 * r2 * r2 + ((n2 + n3) if mode == 1 else (n1 + n2)) * r2 + 8


def _hist_diff(tag, got, want, n, rtol, atol, floor=None) -> str:
    """Hold a history's first n entries to another's within rtol and atol;
    entries of `want` below 20 * floor, where float32 rounding and not the
    algorithm sets the value, within floor instead of atol. Returns the
    largest absolute and relative differences as text."""
    got, want = np.asarray(got, np.float64)[:n], np.asarray(want, np.float64)[:n]
    diff = np.abs(got - want)
    text = f"max |diff| {diff.max():.3e}"
    if floor is not None:
        above = want >= 20 * floor
        text += (f", max rel {np.max(diff[above] / want[above]):.3e} over the {int(above.sum())} entries above "
                 f"{20 * floor:g}")
        atol = np.where(above, atol, floor)
    else:
        text += f", max rel {np.max(diff / np.abs(want)):.3e}"
    if not (diff <= atol + rtol * np.abs(want)).all():
        raise AssertionError(f"{tag}: beyond rtol {rtol:g}, atol {atol} ({text}):\n{got}\nagainst\n{want}")
    return text


# phase 12's mode-1 solve, which phase 19's tritd_admm_auto must equal bitwise
PHASE12_MODE1: dict = {}


def _nccl_one_rank() -> None:
    """This process as a one-rank NCCL group on cuda:0, at a free port."""
    import socket

    from tritd_tpu_torch.parallel.distributed import initialize_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, backend="nccl", device="cuda:0",
                           timeout_s=120.0)


@contextlib.contextmanager
def _sharded_loop(eager: bool):
    """tritd_admm_sharded's loop on one route (`_local_solve`'s `_eager`),
    watched: yields a dict that receives `_watched`'s record of its
    run_admm call."""
    import functools

    from tritd_tpu_torch.parallel import sharded_admm

    record: dict = {}
    local, run = sharded_admm._local_solve, sharded_admm.run_admm

    def watched_run(*args, **kwargs):
        record.update(_watched(lambda: run(*args, **kwargs)))
        return record["res"]

    sharded_admm._local_solve = functools.partial(local, _eager=eager)
    sharded_admm.run_admm = watched_run
    try:
        yield record
    finally:
        sharded_admm._local_solve, sharded_admm.run_admm = local, run


# phase 12's runs: tag, dataset, config, shard_tensor_mode, masked
PHASE12_RUNS = (
    ("taxi mode 1", "taxi", dataclasses.replace(COMPLETION_TRITD, tol=0.0), 1, False),
    ("taxi mode 3", "taxi", dataclasses.replace(COMPLETION_TRITD, tol=0.0), 3, False),
    ("taxi masked storage=bf16 mode 1", "taxi",
     dataclasses.replace(COMPLETION_TRITD, tol=0.0, masked=True, storage_dtype="bfloat16"), 1, True),
    ("video highway mode 3", "highway", dataclasses.replace(VIDEO_TRITD, tol=0.0), 3, False),
)


def phase12() -> dict:
    """One rank on NCCL, in this process: tritd_admm_sharded on its CUDA
    graph route against its eager loop; returns the graph route's kernel
    launches (the first graph run of each case: the main path)."""
    import torch.distributed as dist

    from tritd_tpu_torch.parallel import make_mesh, tritd_admm_sharded

    x, mask, y, _prov = _taxi()
    v_np, _vspec, _vprov = load_dataset("highway")
    data = {"taxi": (y, x), "highway": (torch.as_tensor(v_np, dtype=torch.float32, device="cuda"), None)}
    fields = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")
    _nccl_one_rank()
    total: dict = {}
    try:
        mesh = make_mesh(device_type="cuda")
        for tag, name, cfg, mode, masked in PHASE12_RUNS:
            d, origin = data[name]
            dmask = mask if masked else None
            init = init_factors(torch.Generator().manual_seed(0), tuple(d.shape), cfg.rank, torch.float32)
            ref = tritd_admm(d, cfg, mask=dmask, origin=origin, init=init)
            host = [None if t is None else t.cpu() for t in (d, dmask, origin)]

            def solve(eager, config=cfg):
                hopper_kernels.reset_launch_counts()
                audit: dict = {}
                with _sharded_loop(eager) as record:
                    res = tritd_admm_sharded(host[0], config, mesh, shard_tensor_mode=mode, mask=host[1],
                                             origin=host[2], init=init, audit=audit)
                torch.cuda.synchronize()
                return dict(record, res=res, audit=audit, launches=_launches(), pointer=_pointer_launches())

            for eager in (False, True):  # NCCL's, cuBLAS's and the captures' set-up stay out of the times
                solve(eager, dataclasses.replace(cfg, max_iter=3))
            runs = {False: [], True: []}
            for eager in (False, True, True, False):
                runs[eager].append(solve(eager))
            graph, eager = runs[False][0], runs[True][0]
            n = graph["res"].n_iters
            main = graph["launches"]
            for k, v in main.items():
                total[k] = total.get(k, 0) + v
            _tally_pointer(graph["pointer"])
            differ = [f for f in fields if not _same_bits(getattr(graph["res"], f), getattr(eager["res"], f))]
            again = [f for f in fields for a, b in ((runs[False][1], graph), (runs[True][1], eager))
                     if not _same_bits(getattr(a["res"], f), getattr(b["res"], f))]
            if differ or again or n != eager["res"].n_iters or n != ref.n_iters:
                raise AssertionError(f"phase12 {tag}: the graph route differs from the eager loop in {differ}, a "
                                     f"route from its own second run in {again}; n_iters {n} / "
                                     f"{eager['res'].n_iters} / tritd_admm {ref.n_iters}")
            for on_eager, r in [(route, r) for route, rs in runs.items() for r in rs]:
                if (len(r["launches"]) != 1 or sum(r["launches"].values()) != n
                        or r["pointer"] != ({} if on_eager else r["launches"])):
                    raise AssertionError(f"phase12 {tag}: launches {r['launches']}, through the pointer entry "
                                         f"{r['pointer']}; want one variant {n} times, all through the pointer "
                                         f"entry on the graph route and none on the eager loop")
            budget = _budget_words(tuple(d.shape), cfg.rank, mode)
            per_iter = [r["audit"]["per_iter"] for r in (*runs[False], *runs[True])]
            if any(p != per_iter[0] for p in per_iter) or not (per_iter[0]["calls"] == 4
                                                              and 0 < per_iter[0]["words"] <= budget):
                raise AssertionError(f"phase12 {tag}: all_reduce per iteration {per_iter}, want 4 calls within "
                                     f"{budget} words, the same on both routes")
            # the stop flag before each iteration (one a step, whatever
            # cfg.unroll, as the reference's sharded loop) and the penalties
            want_syncs = cfg.max_iter + 1
            syncs = [r["syncs"] for r in runs[False]]
            if any(s != want_syncs for s in syncs):
                raise AssertionError(f"phase12 {tag}: {syncs} synchronizing calls on the graph route, want {want_syncs}")
            if graph["res"].o.device.type != "cuda" or graph["res"].o.shape != d.shape:
                raise AssertionError(f"phase12 {tag}: O {tuple(graph['res'].o.shape)} on {graph['res'].o.device}")
            # one rank reduces nothing: only the norms differ, roots of reduced
            # sums of squares here, vector norms there
            err = _hist_diff(f"phase12 {tag} err_hist", graph["res"].err_hist.cpu(), ref.err_hist.cpu(), n, 1e-6, 0.0)
            rre_ = ("" if origin is None else ", rre_hist " + _hist_diff(
                f"phase12 {tag} rre_hist", graph["res"].rre_hist.cpu(), ref.rre_hist.cpu(), n, 1e-6, 0.0))
            if tag == "taxi mode 1":  # the counted collectives of the taxi row of phase 18
                for row in T1_ROWS:
                    if row["name"] == "taxi":
                        row["all_reduce"] = dict(per_iter[0])
                PHASE12_MODE1.update(res=graph["res"], cfg=cfg, init=init)
            ms = {route: [r["ms"] / n for r in rs] for route, rs in runs.items()}
            replayed = n - 1
            split = "; ".join(f"run {i + 1}: {_split_text(r, replayed)}" for i, r in enumerate(runs[False]))
            print(f"phase12 nccl 1 rank {tag} ({'x'.join(map(str, d.shape))}, {n} iterations, unroll {cfg.unroll}): "
                  f"launches {main} (all through the pointer entry); graph route {ms[False][0]:.4f} / "
                  f"{ms[False][1]:.4f} ms/iter (events; {split}), eager {ms[True][0]:.4f} / {ms[True][1]:.4f}; "
                  f"loop {graph['audit']['loop_seconds']:.4f} s graph, {eager['audit']['loop_seconds']:.4f} s eager "
                  f"(host clock, synchronized); synchronizing calls a solve graph {syncs} (want {want_syncs}), eager "
                  f"{[r['syncs'] for r in runs[True]]}; peak MiB graph {graph['peak_mib']:.1f}, eager "
                  f"{eager['peak_mib']:.1f}; all_reduce/iter on both routes: {per_iter[0]['calls']} calls, "
                  f"{per_iter[0]['words']} words (budget {budget}), {per_iter[0]['bytes']} bytes; A, B, C, O, E, "
                  f"err_hist, rre_hist bitwise equal between the routes; vs tritd_admm (rtol 1e-6): err_hist "
                  f"{err}{rre_}; {CARD[0]}", flush=True)
    finally:
        dist.destroy_process_group()
    return total


WORKER_TIMEOUT_S = 300.0
# phase 13's iterations: its checks hold every iteration's histories to the
# single process, and the ranks share the card, so its seconds are no
# scaling number: a depth cut from 100 keeps every check and drops the
# second timed run
RANKS_ITERS = 25
# twice the largest distance seen between the single-process float32 run's
# err_hist and the float64 trajectory on the video stand-in (1e-4)
VIDEO_F32_FLOOR = 2e-4


def _single_process(prob: dict, init=None, entry: int | None = None):
    """The single-process solve of a worker's problem (or of one entry of
    its batch) on the card, from the worker's default init."""
    pick = (lambda v: v) if entry is None else (lambda v: None if v is None else v[entry])
    on_card = lambda v: None if v is None else torch.as_tensor(pick(v), device="cuda")  # noqa: E731
    return tritd_admm(on_card(prob["d"]), prob["cfg"], mask=on_card(prob["mask"]), origin=on_card(prob["origin"]),
                      init=init)


def _run_workers(tag: str, world: int, args: list[str], out: str, iters: int = 100, repeats: int = 1) -> dict:
    """`world` workers on cuda:0 over gloo, `iters` iterations and `repeats`
    timed runs after the first; returns rank 0's .npz as a dict."""
    from tritd_tpu_torch.parallel.distributed import launch_local

    t0 = time.perf_counter()
    launch_local(world, ["--backend", "gloo", "--device", "cuda:0", "--max-iter", str(iters), "--bench-repeats",
                         str(repeats), "--out", out, *args], timeout_s=WORKER_TIMEOUT_S)
    with np.load(out) as f:
        got = dict(f)
    got["spawn_seconds"] = time.perf_counter() - t0
    if int(got["world_size"]) != world or str(got["backend"]) != "gloo" or str(got["device"]) != "cuda:0":
        raise AssertionError(f"{tag}: ran as {got['world_size']} ranks on {got['device']} over {got['backend']}")
    return got


def _check_ranks(tag, got, variant, iters_by_rank, factor_scale) -> str:
    """Every rank launched `variant` (a launch count's key, as
    "elementwise_block[f32]") once per iteration and nothing else, and the
    replicated factors agree across ranks."""
    names = [str(n) for n in got["launch_names"]]
    for rank, (row, n) in enumerate(zip(got["launches"], iters_by_rank)):
        counts = {k: int(v) for k, v in zip(names, row) if v}
        if counts != {variant: n}:
            raise AssertionError(f"{tag}: rank {rank} launched {counts}, want {{{variant!r}: {n}}}")
    drift = float(got["replica_max_diff"])
    if not drift <= 1e-6 * factor_scale:
        raise AssertionError(f"{tag}: the factors differ by {drift} between ranks")
    return f"every rank launched {variant} once per iteration; factors across ranks differ by {drift:.1e}"


def phase13() -> None:
    """Several ranks on the one card, each held to the single-process solve."""
    from tritd_tpu_torch.parallel.distributed import build_problem

    runs = (
        # tag, ranks, problem, worker arguments, kernel variant, (rtol, atol, floor)
        ("taxi mode 1", 2, dict(dataset="taxi"), [], "f32", (2e-3, 1e-5, None)),
        ("taxi mode 1 (n1 padded to 102)", 3, dict(dataset="taxi"), [], "f32", (2e-3, 1e-5, None)),
        ("taxi mode 1", 4, dict(dataset="taxi"), [], "f32", (2e-3, 1e-5, None)),
        ("taxi masked storage=bf16 mode 1", 2, dict(dataset="taxi", masked=True, storage_dtype="bfloat16"),
         ["--masked", "--storage-dtype", "bfloat16"], "c32_d32_sbf16_tbf16", (2e-2, 1e-4, None)),
        # On the video data (values up to 295) float32 holds err_hist no
        # lower than 4e-5 to 1e-4: a float64 run falls to 1e-8, a float32 run
        # stays on that floor from iteration 40 on, in one process as on
        # four ranks, and the order of sums decides its digits.
        ("video highway mode 3", 4, dict(dataset="highway"), ["--shard-mode", "3"], "f32", (2e-3, 1e-5, VIDEO_F32_FLOOR)),
    )
    refs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, world, problem, args, variant, (rtol, atol, floor) in runs:
            key = json.dumps(problem, sort_keys=True)
            if key not in refs:
                prob = build_problem(max_iter=RANKS_ITERS, **problem)
                refs[key] = (_single_process(prob), prob["cfg"], prob["d"].shape)
            ref, cfg, shape = refs[key]
            tag = f"phase13 gloo {world} ranks on cuda:0, {tag}"
            got = _run_workers(tag, world, ["--dataset", problem["dataset"], *args], os.path.join(tmp, "out.npz"),
                               iters=RANKS_ITERS, repeats=0)
            n = int(got["n_iters"])
            if n != ref.n_iters:
                raise AssertionError(f"{tag}: n_iters {n}, single process {ref.n_iters}")
            err = _hist_diff(f"{tag} err_hist", got["err_hist"], ref.err_hist.cpu(), n, rtol, atol, floor)
            rre_ = _hist_diff(f"{tag} rre_hist", got["rre_hist"], ref.rre_hist.cpu(), n, rtol, atol)
            mode = 3 if "--shard-mode" in args else 1
            words, budget = int(got["all_reduce_words_per_iter"]), _budget_words(shape, cfg.rank, mode)
            if not 0 < words <= budget:
                raise AssertionError(f"{tag}: {words} all_reduce words per iteration, budget {budget}")
            ranks = _check_ranks(tag, got, f"elementwise_block[{variant}]", [n] * world, float(ref.b.abs().max()))
            print(f"{tag}: iters={n} {float(got['loop_seconds']) / n * 1e3:.3f} ms an iteration (the one run, the "
                  f"slowest rank's loop; the ranks share the card: no scaling number); spawn to result "
                  f"{got['spawn_seconds']:.1f} s; all_reduce/iter: "
                  f"{int(got['all_reduce_calls_per_iter'])} calls, {words} words (budget {budget}); vs single process "
                  f"(rtol {rtol:g}, atol {atol:g}{f', {floor:g} on the float32 floor' if floor else ''}): err_hist {err}, rre_hist {rre_}; {ranks}")


def phase14() -> None:
    """DP x TP on a 2x2 mesh of ranks sharing the card."""
    from tritd_tpu_torch.parallel.distributed import batch_init, build_problem

    tag = "phase14 gloo 2x2 ranks on cuda:0, batch of 2 taxi problems"
    prob = build_problem("taxi", max_iter=100, batch=2)
    inits = batch_init(2, prob["d"].shape[1:], prob["cfg"].rank, torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        got = _run_workers(tag, 4, ["--dataset", "taxi", "--n-data", "2", "--batch", "2"], os.path.join(tmp, "out.npz"))
    iters, texts = [], []
    for i in range(2):
        ref = _single_process(prob, init=inits[i], entry=i)
        n = int(got["n_iters"][i])
        if n != ref.n_iters:
            raise AssertionError(f"{tag}: entry {i} n_iters {n}, single process {ref.n_iters}")
        iters.append(n)
        texts.append(f"entry {i} iters={n} err_hist "
                     + _hist_diff(f"{tag} entry {i} err_hist", got["err_hist"][i], ref.err_hist.cpu(), n, 2e-3, 1e-5)
                     + ", rre_hist "
                     + _hist_diff(f"{tag} entry {i} rre_hist", got["rre_hist"][i], ref.rre_hist.cpu(), n, 2e-3, 1e-5))
    # rank r sits in data group r // 2 and solves that group's one entry in
    # the batched loop: one launch of the batched entry an iteration
    ranks = _check_ranks(tag, got, "elementwise_block_batch[f32]", [iters[r // 2] for r in range(4)],
                         float(ref.b.abs().max()))
    print(f"{tag}: loop {float(got['best_loop_seconds']):.3f} s (second run, slowest rank; the ranks share the card: "
          f"no scaling number); spawn to result {got['spawn_seconds']:.1f} s; vs each entry's single process "
          f"(rtol 2e-3, atol 1e-5): {'; '.join(texts)}; {ranks}")


# --- phase 15: the functional Tensor Toolbox surface ---------------------------

TOOLBOX_OPT_SHAPE = (60, 70, 80)
TOOLBOX_SYM_N = 40  # order 4: 2.56 M entries


def _to(a, device, dtype):
    """numpy arrays (and lists of them) as tensors on `device`: floats in
    `dtype`, complex in the matching complex dtype, int64 coordinates as
    they are; anything else passes through."""
    if isinstance(a, (list, tuple)):
        return [_to(u, device, dtype) for u in a]
    if not isinstance(a, np.ndarray):
        return a
    ten = torch.from_numpy(a)
    if ten.dtype == torch.int64:
        return ten.to(device)
    if ten.is_complex():
        return ten.to(device=device, dtype=torch.complex64 if dtype == torch.float32 else torch.complex128)
    return ten.to(device=device, dtype=dtype)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _rel(got, want) -> float:
    """max |got - want| over max |want|, of tensors or lists of tensors."""
    if isinstance(want, (list, tuple)):
        return max(_rel(g, w) for g, w in zip(got, want))
    want = torch.as_tensor(want)
    wide = torch.complex128 if want.is_complex() else torch.float64
    got, want = torch.as_tensor(got).detach().cpu().to(wide), want.detach().cpu().to(wide)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _absdiff(key):
    return lambda got, want: abs(float(got[key]) - float(want[key]))


def _reldiff(key):
    return lambda got, want: abs(float(got[key]) - float(want[key])) / abs(float(want[key]))


def _projectors(got, want) -> float:
    return _rel(got.double().cpu() @ got.double().cpu().T, want @ want.T)


class _Toolbox:
    """Runs one Toolbox call on the card in float32 (one warm-up, then timed
    with CUDA events) and on the CPU in float64 on the same numpy inputs,
    and holds the first to the second."""

    def __init__(self, phase="phase15"):
        self.phase = phase
        self.rows = []

    def held(self, name, shape, fn, arrays, dist=_rel, tol=1e-4, what="rel diff", min_bytes=None):
        on_card = _to(arrays, "cuda", torch.float32)
        fn(*on_card)  # warm-up: the libraries' one-time set-up stays out of the time
        got, sec, _ = _events(lambda: fn(*on_card))
        _on_card(f"{self.phase} {name}", *_tensors(got))
        # a short call is mostly its launches: the rate of ten in a row is
        # what a caller's loop sees, and what the bound is held against
        first = ""
        if sec < 5e-3:
            first = f", alone {sec * 1e3:.3f} ms"
            sec = _events(lambda: [fn(*on_card) for _ in range(10)])[1] / 10
        t0 = time.perf_counter()
        want = fn(*_to(arrays, "cpu", torch.float64))
        cpu_s = time.perf_counter() - t0
        d = dist(got, want)
        if not d <= tol:
            raise AssertionError(f"{self.phase} {name} {shape}: {what} {d:.3e} to the CPU float64 run, tol {tol:g}")
        bound = ""
        if min_bytes is not None:
            bound_ms = min_bytes / PEAK_BYTES_PER_S * 1e3
            bound = f" bound={bound_ms:.4f} ms by bytes ({bound_ms / (sec * 1e3):.1%} reached)"
        how = "a call over 10 in a row" if first else "second call"
        print(f"{self.phase} {name} {shape}: {sec * 1e3:.3f} ms f32 on the card (events, {how}{first}){bound}; "
              f"cpu f64 {cpu_s * 1e3:.0f} ms; {what} {d:.3e} (tol {tol:g})")
        self.rows.append((name, sec * 1e3))
        return got, want


def _coo(x_np, keep_share, seed):
    """The entries of `x_np` a completion problem observes, as COO."""
    keep = np.random.default_rng(seed).random(x_np.shape) < keep_share
    return x_np[keep], np.argwhere(keep)


def _phase15_dense(tb, ops, x_np) -> None:
    shape = x_np.shape
    tag = "x".join(map(str, shape))
    rng = np.random.default_rng(15)
    f10 = [rng.standard_normal((s, 10)) for s in shape]
    w10 = rng.random(10) + 0.5
    n_el, out_bytes = x_np.size, lambda mode: 4 * shape[mode] * 10

    for mode in range(3):
        tb.held(f"mttkrp mode {mode}", f"{tag} R=10", lambda x, fs, m=mode: ops.mttkrp(x, fs, m), (x_np, f10),
                min_bytes=4 * n_el + 4 * 10 * sum(shape) + out_bytes(mode))
    cut = x_np[:20, :30, :40].copy()
    cut_f = [u[:k] for u, k in zip(f10, (20, 30, 40))]
    for mode in range(3):
        x, fs = _to((cut, cut_f), "cuda", torch.float32)
        others = [fs[ax] for ax in range(3) if ax != mode]
        d = _rel(ops.mttkrp(x, fs, mode), ops.tenmat(x, (mode,)) @ ops.khatrirao(*others))
        if not d <= 1e-5:
            raise AssertionError(f"phase15 mttkrp mode {mode} against tenmat @ khatrirao at 20x30x40: {d:.3e}")
        print(f"phase15 mttkrp mode {mode} 20x30x40 R=10 against tenmat @ khatrirao on the card: rel diff {d:.3e} (tol 1e-5)")
    tb.held("ktensor_full", f"{tag} R=10", lambda fs, w: ops.ktensor_full(fs, w), (f10, w10), tol=1e-5,
            min_bytes=4 * n_el + 4 * 10 * sum(shape))
    for rank in (5, 10):
        tb.held("cp_als init=nvecs 20 iterations", f"{tag} R={rank}",
                lambda x, r=rank: ops.cp_als(x, r, max_iters=20, tol=0.0, init="nvecs"), (x_np,),
                dist=_absdiff("fit"), what="|fit diff|")
    tb.held("tucker_hosvd", f"{tag} ranks 5,5,5", lambda x: ops.tucker_hosvd(x, (5, 5, 5)), (x_np,),
            dist=lambda g, w: _rel(torch.linalg.vector_norm(g["core"]), torch.linalg.vector_norm(w["core"])),
            what="rel diff of ||core||")
    tb.held("tucker_hooi 10 iterations", f"{tag} ranks 5,5,5",
            lambda x: ops.tucker_hooi(x, (5, 5, 5), max_iters=10, tol=0.0), (x_np,),
            dist=_absdiff("fit"), what="|fit diff|")
    for mode in range(3):
        tb.held(f"nvecs mode {mode}", f"{tag} r=5", lambda x, m=mode: ops.nvecs(x, m, 5), (x_np,),
                dist=_projectors, tol=1e-3, what="rel diff of U U^T")
    u = rng.standard_normal((50, shape[1]))
    tb.held("ttm mode 1", f"{tag} by 50x{shape[1]}", lambda x, m: ops.ttm(x, m, 1), (x_np, u),
            min_bytes=4 * n_el + 4 * n_el // 2)
    tb.held("ttv mode 2", tag, lambda x, v: ops.ttv(x, v, 2), (x_np, rng.standard_normal(shape[2])),
            min_bytes=4 * n_el)
    tb.held("ttt over mode 2", f"{tag} with {shape[2]}x7", lambda x, b: ops.ttt(x, b, 2, 0),
            (x_np, rng.standard_normal((shape[2], 7))), min_bytes=4 * n_el)
    tb.held("ktensor_norm", f"{tag} R=10", lambda w, fs: ops.ktensor_norm(w, fs), (w10, f10))
    tb.held("ktensor_innerprod with a dense tensor", f"{tag} R=10",
            lambda w, fs, x: ops.ktensor_innerprod(w, fs, x), (w10, f10, x_np), tol=1e-3,
            min_bytes=4 * n_el)
    core = rng.standard_normal((5, 5, 5))
    f5 = [rng.standard_normal((s, 5)) for s in shape]
    tb.held("ttensor_norm", f"{tag} core 5x5x5", lambda c, fs: ops.ttensor_norm(c, fs), (core, f5))
    init5 = [rng.random((s, 5)) for s in shape]
    tb.held("cp_nmu 20 iterations", f"{tag} R=5 on |x|",
            lambda x, fs: ops.cp_nmu(x.abs(), 5, max_iters=20, tol=0.0, init_factors=fs), (x_np, init5),
            dist=_absdiff("fit"), what="|fit diff|")
    # the sample indices come from a CPU generator: one seed, the same
    # samples on the card and on the CPU
    tb.held("cp_arls 20 iterations, 400 samples", f"{tag} R=5",
            lambda x, fs: ops.cp_arls(x, 5, n_samples=400, max_iters=20, tol=0.0,
                                      generator=torch.Generator().manual_seed(15), init_factors=fs),
            (x_np, init5), dist=_absdiff("fit"), tol=1e-3, what="|fit diff|")


def _phase15_sparse(tb, ops, x_np) -> None:
    shape = x_np.shape
    tag = "x".join(map(str, shape))
    rng = np.random.default_rng(16)
    f10 = [rng.standard_normal((s, 10)) for s in shape]
    dense_model = rng.standard_normal(shape)
    vec = rng.standard_normal(shape[2])
    for keep in (0.10, 0.90):
        vals, coords = _coo(x_np, keep, seed=int(keep * 100))
        nnz = vals.size
        sp = f"{tag} nnz={nnz}"
        coo_bytes = nnz * (4 + 3 * 8)
        tb.held("sp_full", sp, lambda v, c: ops.sp_full(v, c, shape), (vals, coords), tol=1e-6,
                min_bytes=coo_bytes + 4 * x_np.size)
        branch = "dense" if x_np.size <= 4 * nnz else "sorted runs"
        tb.held(f"sp_norm ({branch} branch)", sp, lambda v, c: ops.sp_norm(v, c, shape), (vals, coords),
                tol=1e-5, min_bytes=coo_bytes)
        tb.held("sp_innerprod", sp, lambda v, c, d: ops.sp_innerprod(v, c, shape, d), (vals, coords, dense_model),
                tol=1e-3, min_bytes=coo_bytes + 4 * nnz)
        tb.held("sp_ttv mode 2", sp, lambda v, c, w: ops.sp_ttv(v, c, shape, [w], [2]), (vals, coords, vec),
                min_bytes=coo_bytes + 4 * shape[0] * shape[1])
        for mode in range(3):
            # each nonzero: its value and coordinates read, R floats of each
            # other factor gathered, R floats added into the output
            floor = coo_bytes + 4 * 10 * sum(shape)
            got, _ = tb.held(f"sp_mttkrp mode {mode}", f"{sp} R=10",
                             lambda v, c, fs, m=mode: ops.sp_mttkrp(v, c, shape, fs, m), (vals, coords, f10),
                             min_bytes=floor)
            v, c, fs = _to((vals, coords, f10), "cuda", torch.float32)
            d = _rel(got, ops.mttkrp(ops.sp_full(v, c, shape), fs, mode))
            if not d <= 1e-4:
                raise AssertionError(f"phase15 sp_mttkrp mode {mode} {sp} against the dense mttkrp of sp_full: {d:.3e}")
        # the library's sparse product on the same numbers: X_(0) as a
        # coalesced COO matrix times the Khatri-Rao matrix of the other two
        v, c, fs = _to((vals, coords, f10), "cuda", torch.float32)
        torch.sparse.check_sparse_tensor_invariants.disable()  # said aloud: the default, with a warning
        ridx = c[:, 0]
        cidx = c[:, 1] * shape[2] + c[:, 2]
        mat = torch.sparse_coo_tensor(torch.stack([ridx, cidx]), v, (shape[0], shape[1] * shape[2])).coalesce()
        lib = lambda: torch.sparse.mm(mat, ops.khatrirao(fs[1], fs[2]))  # noqa: E731
        out = lib()
        lib_s = _events(lambda: [lib() for _ in range(10)])[1] / 10
        d = _rel(out, ops.sp_mttkrp(v, c, shape, fs, 0))
        if not d <= 1e-4:
            raise AssertionError(f"phase15 torch.sparse.mm against sp_mttkrp mode 0 {sp}: {d:.3e}")
        print(f"phase15 library: torch.sparse.mm(X_(0) coalesced COO, khatrirao) {sp} R=10: {lib_s * 1e3:.3f} ms "
              f"(events, a call over 10 in a row; used nowhere in the port), rel diff to sp_mttkrp {d:.3e}")

    vals, coords = _coo(x_np, 0.10, seed=10)
    init5 = [rng.random((s, 5)) for s in shape]
    got, _ = tb.held("cp_als_sparse 20 iterations", f"{tag} nnz={vals.size} R=5",
                     lambda v, c, fs: ops.cp_als_sparse(v, c, shape, 5, max_iters=20, tol=0.0, init_factors=fs),
                     (vals, coords, init5), dist=_absdiff("fit"), what="|fit diff|")
    v, c, fs = _to((vals, coords, init5), "cuda", torch.float32)
    dense = ops.cp_als(ops.sp_full(v, c, shape), 5, max_iters=20, tol=0.0, init_factors=fs)
    d = abs(float(dense["fit"]) - float(got["fit"]))
    if not d <= 1e-4:
        raise AssertionError(f"phase15 cp_als_sparse against cp_als on the zero-filled tensor: fits differ by {d:.3e}")
    print(f"phase15 cp_als_sparse against cp_als on the zero-filled dense tensor, same init, on the card: "
          f"fit {float(got['fit']):.6f} and {float(dense['fit']):.6f}, |diff| {d:.3e} (tol 1e-4)")


def _phase15_symmetric(tb, ops) -> None:
    n = TOOLBOX_SYM_N
    tag = f"{n}^4"
    rng = np.random.default_rng(17)
    noise = rng.standard_normal((n,) * 4)
    got, want = tb.held("symmetrize", tag, ops.symmetrize, (noise,), tol=1e-5, min_bytes=8 * noise.size)
    if not (bool(ops.is_symmetric(got, tol=1e-4)) and not bool(ops.is_symmetric(_to(noise, "cuda", torch.float32)))):
        raise AssertionError("phase15 is_symmetric: wrong on the symmetrized tensor or on the raw one")
    # three symmetric rank-one terms over a symmetric noise floor
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    w = np.array([5.0, 3.0, 2.0])
    a = 0.02 * want.numpy() + ops.symktensor_full(torch.from_numpy(w), torch.from_numpy(u), 4).numpy()
    x0 = rng.standard_normal(n)
    for keep in (0, 1, 2):
        tb.held(f"ttsv keep={keep}", tag, lambda t, x, k=keep: ops.ttsv(t, x, k), (a, x0), min_bytes=4 * a.size)

    def residual(t, res, b=None):
        lam, x = res["eigval"], res["eigvec"]
        t = t.to(x.dtype)
        rhs = x if b is None else ops.ttsv(b.to(x.dtype), x, 1)
        return float(torch.linalg.vector_norm(ops.ttsv(t, x, 1) - lam * rhs))

    def eig(name, fn, arrays, b_index=None):
        got, want = tb.held(name, tag, fn, arrays, dist=lambda g, w_: abs(complex(g["eigval"]) - complex(w_["eigval"])),
                            tol=1e-4, what="|eigenvalue diff|")
        on_card = _to(arrays, "cuda", torch.float32)
        r = residual(on_card[0], got, None if b_index is None else on_card[b_index])
        if not r < 1e-3:
            raise AssertionError(f"phase15 {name}: eigen-residual {r:.3e} on the card, bar 1e-3")
        print(f"phase15 {name} {tag}: eigenvalue {complex(got['eigval']):.6f} after {got['n_iters']} iterations "
              f"(cpu f64: {want['n_iters']}), eigen-residual {r:.3e} (bar 1e-3)")
        return got

    real = eig("eig_sshopm", lambda t, x: ops.eig_sshopm(t, shift=1.0, max_iters=300, tol=1e-7, x0=x), (a, x0))
    t0 = time.perf_counter()
    eye = ops.teneye(4, n, dtype=torch.float64, device="cpu").numpy()
    print(f"phase15 teneye(4, {n}) built on the host in {time.perf_counter() - t0:.2f} s")
    eig("eig_geap with B = teneye", lambda t, b, x: ops.eig_geap(t, b, shift=1.0, max_iters=300, tol=1e-7, x0=x),
        (a, eye, x0), b_index=1)
    start = real["eigvec"].double().cpu().numpy() + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    eig("eig_sshopmc (complex64)", lambda t, x: ops.eig_sshopmc(t, shift=2.0, max_iters=300, tol=1e-7, x0=x),
        (a, start))
    tb.held("tucker_sym", f"{tag} rank 3", lambda t: ops.tucker_sym(t, 3, max_iters=20, tol=1e-6), (a,),
            dist=_absdiff("fit"), what="|fit diff|")
    w0, u0 = rng.standard_normal(3), rng.standard_normal((n, 3)) / np.sqrt(n)
    tb.held("cp_sym 200 Adam steps", f"{tag} rank 3",
            lambda t, w_, u_: ops.cp_sym(t, 3, max_iters=200, tol=0.0, init=(w_, u_)), (a, w0, u0),
            dist=lambda g, w_: abs((1 - float(g["fit"])) ** 2 - (1 - float(w_["fit"])) ** 2) / (1 - float(w_["fit"])) ** 2,
            tol=0.05, what="rel diff of the loss")


def _phase15_optimisers(tb, ops) -> None:
    shape = TOOLBOX_OPT_SHAPE
    tag = "x".join(map(str, shape)) + " R=5"
    rng = np.random.default_rng(18)
    truth = [rng.random((s, 5)) + 0.1 for s in shape]
    clean = np.einsum("ir,jr,kr->ijk", *truth)
    nz = rng.standard_normal(shape)
    x = clean + 0.1 * np.linalg.norm(clean) / np.linalg.norm(nz) * nz
    init = [0.1 * rng.standard_normal((s, 5)) for s in shape]
    # L-BFGS starts at the data's own scale, as it has since this phase was
    # written: then the line search stalled in float32 at the 0.1-normal
    # default (phase 16 now holds that start on its own)
    init_lbfgs = [rng.random((s, 5)) for s in shape]
    init_pos = [0.5 * rng.random((s, 5)) + 0.01 for s in shape]
    mask = (rng.random(shape) > 0.3).astype(np.float64)

    def loss_of(key):
        if key == "fit":  # fit = 1 - sqrt(loss)
            return lambda g, w: abs((1 - float(g[key])) ** 2 - (1 - float(w[key])) ** 2) / (1 - float(w[key])) ** 2
        return _reldiff(key)

    def finite(name, res):
        if not all(bool(torch.isfinite(t).all()) for t in _tensors(res)):
            raise AssertionError(f"phase15 {name}: not finite")

    got, _ = tb.held("cp_opt 100 L-BFGS iterations", tag,
                     lambda t, fs: ops.cp_opt(t, 5, max_iters=100, tol=0.0, init_factors=fs), (x, init_lbfgs),
                     dist=loss_of("fit"), tol=0.05, what="rel diff of the final loss")
    finite("cp_opt", got)
    got, _ = tb.held("cp_wopt 100 L-BFGS iterations, 30% masked", tag,
                     lambda t, m, fs: ops.cp_wopt(t, m, 5, max_iters=100, tol=0.0, init_factors=fs), (x, mask, init_lbfgs),
                     dist=loss_of("fit"), tol=0.05, what="rel diff of the final loss")
    finite("cp_wopt", got)
    data = {"normal": (x, init), "count": (np.round(5.0 * np.abs(x)), init_pos),
            "bernoulli-logit": ((x > np.median(x)).astype(np.float64), init)}
    for loss, (d, start) in data.items():
        got, _ = tb.held(f"gcp_opt {loss} 100 Adam steps", tag,
                         lambda t, fs, name=loss: ops.gcp_opt(t, 5, loss=name, max_iters=100, tol=0.0, init_factors=fs),
                         (d, start), dist=loss_of("objective"), tol=0.05, what="rel diff of the final loss")
        finite(f"gcp_opt {loss}", got)


def phase15() -> None:
    """The functional Tensor Toolbox surface on the card, float32 with TF32
    off, each call held to the same call on the CPU in float64."""
    from tritd_tpu_torch import ops

    t0 = time.perf_counter()
    tb = _Toolbox()
    x_np, _spec, _prov = load_dataset("taxi")
    x_np = np.ascontiguousarray(x_np, dtype=np.float64)
    _phase15_dense(tb, ops, x_np)
    _phase15_sparse(tb, ops, x_np)
    _phase15_symmetric(tb, ops)
    _phase15_optimisers(tb, ops)
    slowest = sorted(tb.rows, key=lambda r: -r[1])[:5]
    print(f"phase15 toolbox: {len(tb.rows)} calls held to the CPU float64 run in {time.perf_counter() - t0:.1f} s; "
          f"slowest on the card: " + ", ".join(f"{name} {ms:.2f} ms" for name, ms in slowest))


TOOLBOX_CLASS_RANK = 10
TOOLBOX_CLASS_CORE = (5, 5, 5)


def _phase16_dense(tb, C, x_np) -> None:
    """Tensor, KTensor, TTensor and SumTensor at the taxi stand-in's shape."""
    shape = x_np.shape
    tag = "x".join(map(str, shape))
    rng = np.random.default_rng(26)
    n_el = x_np.size
    f10 = [rng.standard_normal((s, TOOLBOX_CLASS_RANK)) for s in shape]
    w10 = rng.random(TOOLBOX_CLASS_RANK) + 0.5
    core = rng.standard_normal(TOOLBOX_CLASS_CORE)
    f5 = [rng.standard_normal((s, r)) for s, r in zip(shape, TOOLBOX_CLASS_CORE)]
    u = rng.standard_normal((50, shape[1]))
    v = rng.standard_normal(shape[2])
    vals, coords = _coo(x_np, 0.10, seed=10)
    kt = f"R={TOOLBOX_CLASS_RANK}"

    tb.held("Tensor.ttm mode 1", f"{tag} by 50x{shape[1]}", lambda x, m: C.Tensor(x).ttm(m, 1).data, (x_np, u),
            min_bytes=4 * n_el + 4 * n_el // 2)
    tb.held("Tensor.ttv mode 2", tag, lambda x, w: C.Tensor(x).ttv(w, 2).data, (x_np, v), min_bytes=4 * n_el)
    tb.held("Tensor.mttkrps", f"{tag} {kt}", lambda x, fs: C.Tensor(x).mttkrps(fs), (x_np, f10),
            min_bytes=3 * (4 * n_el + 4 * 10 * sum(shape)))
    for mode in range(3):
        tb.held(f"Tensor.nvecs mode {mode}", f"{tag} r=5", lambda x, m=mode: C.Tensor(x).nvecs(m, 5), (x_np,),
                dist=_projectors, tol=1e-3, what="rel diff of U U^T")
    tb.held("Tensor.norm", tag, lambda x: C.Tensor(x).norm(), (x_np,), min_bytes=4 * n_el)
    tb.held("Tensor.innerprod(Tensor)", tag, lambda x: C.Tensor(x).innerprod(C.Tensor(x)), (x_np,),
            min_bytes=4 * n_el)
    tb.held("Tensor.innerprod(KTensor)", f"{tag} {kt}",
            lambda x, fs, w: C.Tensor(x).innerprod(C.KTensor(fs, w)), (x_np, f10, w10), tol=1e-3,
            min_bytes=4 * n_el)
    tb.held("Tensor.innerprod(TTensor)", f"{tag} core 5x5x5",
            lambda x, c, fs: C.Tensor(x).innerprod(C.TTensor(c, fs)), (x_np, core, f5), tol=1e-3,
            min_bytes=4 * n_el)
    tb.held("Tensor.innerprod(SpTensor)", f"{tag} nnz={vals.size}",
            lambda x, sv, c: C.Tensor(x).innerprod(C.SpTensor(sv, c, shape)), (x_np, vals, coords), tol=1e-3,
            min_bytes=vals.size * (4 + 3 * 8 + 4))
    tb.held("Tensor.innerprod(SumTensor: dense + Kruskal + sparse)", f"{tag} {kt} nnz={vals.size}",
            lambda x, fs, w, sv, c: C.Tensor(x).innerprod(C.SumTensor([C.Tensor(x), C.KTensor(fs, w),
                                                                         C.SpTensor(sv, c, shape)])),
            (x_np, f10, w10, vals, coords), tol=1e-3)
    tb.held("Tensor.to_tenmat((1,)).to_tensor()", tag, lambda x: C.Tensor(x).to_tenmat((1,)).to_tensor().data,
            (x_np,), tol=1e-6, min_bytes=8 * n_el)
    tb.held("Tensor.collapse((0, 1))", tag, lambda x: C.Tensor(x).collapse((0, 1)).data, (x_np,),
            min_bytes=4 * n_el)
    tb.held("Tensor.scale(s, 2)", tag, lambda x, s: C.Tensor(x).scale(s, 2).data, (x_np, v), min_bytes=8 * n_el)

    tb.held("KTensor.full", f"{tag} {kt}", lambda fs, w: C.KTensor(fs, w).full().data, (f10, w10), tol=1e-5,
            min_bytes=4 * n_el)
    tb.held("KTensor.norm", f"{tag} {kt}", lambda fs, w: C.KTensor(fs, w).norm(), (f10, w10))
    tb.held("KTensor.innerprod(KTensor)", f"{tag} {kt}",
            lambda fs, w: C.KTensor(fs, w).innerprod(C.KTensor(fs, w)), (f10, w10))
    tb.held("KTensor.nvecs mode 2", f"{tag} {kt} r=5", lambda fs, w: C.KTensor(fs, w).nvecs(2, 5), (f10, w10),
            dist=_projectors, tol=1e-3, what="rel diff of U U^T")
    tb.held("KTensor.normalize().arrange().full", f"{tag} {kt}",
            lambda fs, w: C.KTensor(fs, w).normalize().arrange().full().data, (f10, w10), tol=1e-5)
    tb.held("TTensor.full", f"{tag} core 5x5x5", lambda c, fs: C.TTensor(c, fs).full().data, (core, f5),
            tol=1e-5, min_bytes=4 * n_el)
    tb.held("TTensor.norm", f"{tag} core 5x5x5", lambda c, fs: C.TTensor(c, fs).norm(), (core, f5))
    tb.held("TTensor.innerprod(TTensor)", f"{tag} core 5x5x5",
            lambda c, fs: C.TTensor(c, fs).innerprod(C.TTensor(c, fs)), (core, f5), tol=1e-3)
    tb.held("TTensor.nvecs mode 1", f"{tag} core 5x5x5 r=3", lambda c, fs: C.TTensor(c, fs).nvecs(1, 3),
            (core, f5), dist=_projectors, tol=1e-3, what="rel diff of U U^T")

    def sumt(x, fs, w, sv, c):
        return C.SumTensor([C.Tensor(x), C.KTensor(fs, w), C.SpTensor(sv, c, shape)])

    tb.held("SumTensor.mttkrp mode 1", f"{tag} {kt}", lambda x, fs, w, sv, c, g: sumt(x, fs, w, sv, c).mttkrp(g, 1),
            (x_np, f10, w10, vals, coords, f10), tol=1e-3)
    tb.held("SumTensor.ttv mode 2", f"{tag} {kt}", lambda x, fs, w, sv, c, vv: sumt(x, fs, w, sv, c).ttv([vv], [2]),
            (x_np, f10, w10, vals, coords, v), tol=1e-3)


def _phase16_sparse(tb, C, x_np) -> None:
    shape = x_np.shape
    vals, coords = _coo(x_np, 0.10, seed=10)
    nnz = vals.size
    sp = f"{'x'.join(map(str, shape))} nnz={nnz}"
    coo_bytes = nnz * (4 + 3 * 8)
    rng = np.random.default_rng(27)
    f10 = [rng.standard_normal((s, TOOLBOX_CLASS_RANK)) for s in shape]
    u = rng.standard_normal((50, shape[1]))
    v = rng.standard_normal(shape[2])
    dense_model = rng.standard_normal(shape)
    tb.held("SpTensor.full", sp, lambda sv, c: C.SpTensor(sv, c, shape).full().data, (vals, coords), tol=1e-6,
            min_bytes=coo_bytes + 4 * x_np.size)
    for mode in range(3):
        tb.held(f"SpTensor.mttkrp mode {mode}", f"{sp} R=10",
                lambda sv, c, fs, m=mode: C.SpTensor(sv, c, shape).mttkrp(fs, m), (vals, coords, f10),
                min_bytes=coo_bytes + 4 * 10 * sum(shape))
    tb.held("SpTensor.ttv mode 2", sp, lambda sv, c, w: C.SpTensor(sv, c, shape).ttv(w, 2).data,
            (vals, coords, v), min_bytes=coo_bytes + 4 * shape[0] * shape[1])
    tb.held("SpTensor.ttm mode 1", f"{sp} by 50x{shape[1]}", lambda sv, c, m: C.SpTensor(sv, c, shape).ttm(m, 1).data,
            (vals, coords, u), min_bytes=coo_bytes + 4 * x_np.size // 2)
    tb.held("SpTensor.innerprod(Tensor)", sp, lambda sv, c, d: C.SpTensor(sv, c, shape).innerprod(C.Tensor(d)),
            (vals, coords, dense_model), tol=1e-3, min_bytes=coo_bytes + 4 * nnz)
    tb.held("SpTensor.to_sptenmat((0,)).to_sptensor().full", sp,
            lambda sv, c: C.SpTensor(sv, c, shape).to_sptenmat((0,)).to_sptensor().full().data, (vals, coords),
            tol=1e-6)
    tb.held("SpTensor.norm", sp, lambda sv, c: C.SpTensor(sv, c, shape).norm(), (vals, coords), tol=1e-5,
            min_bytes=coo_bytes)


def _phase16_symmetric(tb, C) -> None:
    n = TOOLBOX_SYM_N
    tag = f"{n}^4"
    rng = np.random.default_rng(28)
    noise = rng.standard_normal((n,) * 4)
    u_true = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    w_true = np.array([5.0, 3.0, 2.0])
    tb.held("SymTensor (symmetrize)", tag, lambda a: C.SymTensor(a).data, (noise,), tol=1e-5,
            min_bytes=8 * noise.size)
    tb.held("SymTensor.norm", tag, lambda a: C.SymTensor(a, presymmetrized=True).norm(), (noise,),
            min_bytes=4 * noise.size)
    tb.held("SymKTensor.full", f"{tag} rank 3", lambda w, u: C.SymKTensor(w, u, 4).full().data, (w_true, u_true),
            tol=1e-5, min_bytes=4 * noise.size)
    tb.held("SymKTensor.norm", f"{tag} rank 3", lambda w, u: C.SymKTensor(w, u, 4).norm(), (w_true, u_true))
    a = C.SymKTensor(torch.from_numpy(w_true), torch.from_numpy(u_true), 4).full().data.numpy() + 0.02 * noise
    w0, u0 = rng.standard_normal(3), rng.standard_normal((n, 3)) / np.sqrt(n)

    def fg(t, w, u):
        model = C.SymKTensor(w, u, 4)
        return list(model.fg(model.fg_setup(C.SymTensor(t))))

    got, _ = tb.held("SymKTensor.fg (F and its gradient)", f"{tag} rank 3", fg, (a, w0, u0), tol=1e-3)
    on_card = _to((a, w0, u0), "cuda", torch.float32)
    vec = C.SymKTensor(on_card[1], on_card[2], 4).tovec().clone().requires_grad_(True)
    target = C.SymTensor(on_card[0])
    loss = ((target.data - C.SymKTensor.from_vec(vec, n, 3, 4).full().data) ** 2).sum()
    (g_auto,) = torch.autograd.grad(loss, vec)
    d_f, d_g = _rel(got[0], loss.detach()), _rel(got[1], g_auto)
    if not (d_f <= 1e-4 and d_g <= 1e-3):
        raise AssertionError(f"phase16 SymKTensor.fg against torch.autograd on the card: F {d_f:.3e}, G {d_g:.3e}")
    print(f"phase16 SymKTensor.fg {tag} against torch.autograd of ||A - full(M)||^2 on the card: "
          f"F rel diff {d_f:.3e} (tol 1e-4), gradient {d_g:.3e} (tol 1e-3)")


def _phase16_cp_opt_default_init(ops) -> None:
    """ROADMAP fault 2, repaired: cp_opt from the reference's 0.1-normal
    default init leaves the saddle in float32 on the card."""
    shape = TOOLBOX_OPT_SHAPE
    rng = np.random.default_rng(18)
    truth = [rng.random((s, 5)) + 0.1 for s in shape]
    clean = np.einsum("ir,jr,kr->ijk", *truth)
    nz = rng.standard_normal(shape)
    x = torch.as_tensor(clean + 0.1 * np.linalg.norm(clean) / np.linalg.norm(nz) * nz, dtype=torch.float32,
                        device="cuda")
    res, sec, _ = _events(lambda: ops.cp_opt(x, 5, max_iters=30, tol=0.0, generator=torch.Generator().manual_seed(0)))
    loss = (1.0 - float(res["fit"])) ** 2
    if not loss < 0.1:
        raise AssertionError(f"phase16 cp_opt f32 from the default init: loss {loss:.6f} after 30 iterations")
    print(f"phase16 cp_opt f32 {'x'.join(map(str, shape))} R=5 from the default 0.1-normal init, 30 L-BFGS "
          f"iterations: loss {loss:.6f} (start 1; bar 0.1) in {sec * 1e3:.1f} ms")


def phase16() -> None:
    """The nine Tensor Toolbox classes on the card in float32, each call
    timed and held to the same call on the CPU in float64 (phase 15's
    rule), then the port's method audit."""
    from tritd_tpu_torch import ops
    from tritd_tpu_torch.ops import classes as C
    from tritd_tpu_torch.tools import toolbox_audit

    t0 = time.perf_counter()
    tb = _Toolbox("phase16")
    x_np, _spec, _prov = load_dataset("taxi")
    x_np = np.ascontiguousarray(x_np, dtype=np.float64)
    _phase16_dense(tb, C, x_np)
    _phase16_sparse(tb, C, x_np)
    _phase16_symmetric(tb, C)
    _phase16_cp_opt_default_init(ops)
    _rows, n_impl, n_na, problems = toolbox_audit.audit()
    if problems or (n_impl, n_na) != (249, 31) or toolbox_audit.main(["--check"]) != 0:
        raise AssertionError(f"phase16 toolbox_audit: {n_impl} impl, {n_na} n/a, problems {problems}")
    print(f"phase16 toolbox_audit --check: {n_impl} implemented, {n_na} n/a, {len(problems)} problems")
    slowest = sorted(tb.rows, key=lambda r: -r[1])[:5]
    print(f"phase16 classes: {len(tb.rows)} calls held to the CPU float64 run in {time.perf_counter() - t0:.1f} s; "
          f"slowest on the card: " + ", ".join(f"{name} {ms:.2f} ms" for name, ms in slowest))


EMULATOR_TAXI_ITERS = 30  # the emulator takes about 0.6-0.9 s an iteration at taxi on the host
EMULATOR_SENSOR_ITERS = 100  # the protocol depth
EMULATOR_F64_BAR = 1e-10  # max|d err_hist| of every float64 row, as the CPU tests hold it


def phase17() -> dict:
    """Emulator parity on the card in float64: `triple` at the full taxi
    width for EMULATOR_TAXI_ITERS iterations, then all five methods at the
    sensor shape at their protocol depth, the emulator sides in worker
    processes beside the port sides. Returns the kernel launches."""
    from tritd_tpu_torch.tools import emulator_parity as ep

    t0 = time.perf_counter()
    taxi, sensor = ep.problem("taxi"), ep.problem("sensor")
    jobs = [("triple", taxi, EMULATOR_TAXI_ITERS)] + [(m, sensor, EMULATOR_SENSOR_ITERS) for m in ep.METHODS]
    rows = ep.run_many(jobs, device="cuda", dtype=torch.float64, workers=len(jobs))
    launches: dict = {}
    for (method, prob, depth), row in zip(jobs, rows):
        row.update(dataset=prob.spec.name, shape=list(prob.x.shape), provenance=prob.provenance, max_iter=depth)
        print(json.dumps(row))
        for k, v in row["kernel_launches"].items():
            launches[k] = launches.get(k, 0) + v
        _tally_pointer(row["pointer_launches"])
        want = {"f64": row["n_iters_port"]} if method == "triple" else {}
        if row["kernel_launches"] != want:
            raise AssertionError(f"phase17 {prob.spec.name} {method}: launches {row['kernel_launches']}, want {want}")
        if not row["pass"]:
            raise AssertionError(f"phase17 {prob.spec.name} {method}: fails its bar: {row}")
    # PASS_BAR is the reference's; a float64 run on the card is held far
    # tighter, so that a solve at a lower precision fails here
    for (method, prob, _), row in zip(jobs, rows):
        if not (row["iters_match"] and row["max_abs_diff_err_hist"] <= EMULATOR_F64_BAR):
            raise AssertionError(f"phase17 {prob.spec.name} {method}: max|d err_hist| "
                                 f"{row['max_abs_diff_err_hist']:.3e} over the float64 bar {EMULATOR_F64_BAR:g}: {row}")
    taxi_row = rows[0]
    print(f"phase17 emulator parity, f64 on the card: {len(rows)} rows pass in {time.perf_counter() - t0:.1f} s; "
          f"taxi triple {taxi_row['n_iters_port']} iterations, max|d err_hist| "
          f"{taxi_row['max_abs_diff_err_hist']:.3e}, f64 T' launches {taxi_row['kernel_launches']}; "
          + ", ".join(f"sensor {r['method']} {r['max_abs_diff_err_hist']:.2e} ({r['seconds_port']:.2f} s port, "
                      f"{r['seconds_emulator']:.2f} s emulator)" for r in rows[1:]))
    return launches


def phase18() -> None:
    """The scaling model (`tools/scaling_model.py`) on the one-card rates of
    phase 3 and the collectives phase 12 counted; prints its JSON line.
    Every multi-GPU figure in it is predicted."""
    from tritd_tpu_torch.tools import scaling_model

    if len(T1_ROWS) != 2 or "all_reduce" not in T1_ROWS[0]:
        raise AssertionError(f"phase18: the rows of phases 3 and 12 are missing: {T1_ROWS}")
    with tempfile.TemporaryDirectory() as tmp:
        rows = os.path.join(tmp, "rows.json")
        with open(rows, "w") as fh:
            json.dump(T1_ROWS, fh)
        result = scaling_model.main(["--rows", rows, "--out", os.path.join(tmp, "SCALING_MODEL.md")])
    for row in result["rows"]:
        if not (row["t1_us_measured"] > 0 and all(t > 0 for t in row["predicted_us"].values())):
            raise AssertionError(f"phase18: {row}")
    print("phase18 scaling model: " + "; ".join(
        f"{r['name']} T1 {r['t1_us_measured']:.1f} us measured, predicted efficiency at 8 GPUs "
        f"{100 * r['predicted_efficiency']['8']:.0f}%, at 16 on 2 hosts "
        f"{100 * r['predicted_efficiency']['16 (2 hosts)']:.0f}%"
        for r in result["rows"]))


def _same_as_tensor_call(tag, got, want, scale) -> str:
    """Hold the outputs of a call from numpy to those of the same call on
    CUDA tensors: bitwise, or else within rtol 1e-6 and atol 1e-6 * `scale`
    (max |input|; ROADMAP's float32 tolerance on the card), which is said."""
    if isinstance(got, dict):
        if not isinstance(want, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{tag}: outputs {sorted(got)} against {sorted(want)}")
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
    if isinstance(got, (tuple, list)):
        if not isinstance(want, (tuple, list)) or len(got) != len(want):
            raise AssertionError(f"{tag}: {len(got)} outputs against {len(want)}")
        texts = [_same_as_tensor_call(tag, g, w, scale) for g, w in zip(got, want)]
        return "bitwise" if all(t == "bitwise" for t in texts) else "; ".join(t for t in texts if t != "bitwise")
    if isinstance(got, torch.Tensor):
        if got.device.type != "cuda" or want.device.type != "cuda":
            raise AssertionError(f"{tag}: results on {got.device} and {want.device}")
        if torch.equal(torch.nan_to_num(got, nan=0.5), torch.nan_to_num(want, nan=0.5)) and \
                torch.equal(got.isnan(), want.isnan()):
            return "bitwise"
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale, equal_nan=True, msg=lambda m: f"{tag}: {m}")
        diff = float((got.double() - want.double()).abs().nan_to_num().max())
        return f"not bitwise (max |diff| {diff:.3e}; a cuSOLVER or cuBLAS route not bitwise from run to run)"
    if isinstance(got, np.ndarray):
        if np.array_equal(got, want, equal_nan=True):
            return "bitwise"
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale, err_msg=tag)
        return f"not bitwise (max |diff| {np.nanmax(np.abs(got - want)):.3e})"
    if got != want:
        raise AssertionError(f"{tag}: {got} against {want}")
    return "bitwise"


def phase19() -> dict:
    """Numpy input to the baselines and to tritd_admm_auto, on the card;
    returns the kernel launches of the tritd_admm_auto solve."""
    import importlib

    import torch.distributed as dist

    from tritd_tpu_torch.baselines import (fctn_compose, rc_fctn_driver_traffic, rnc_fctn, rtrc, sofia_init,
                                           sofia_stream_device, trpca_tnn, tt_trpca)
    from tritd_tpu_torch.parallel import make_mesh, tritd_admm_auto

    sofia = importlib.import_module("tritd_tpu_torch.baselines.sofia")
    x_np, spec, _prov = load_dataset("taxi")
    mask_np = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    x32 = x_np.astype(np.float32)
    y32 = np.where(mask_np, x32, np.float32(0.0))
    # phase 10's rnc_fctn problem, made on the host
    gen = torch.Generator().manual_seed(10)
    cores = [torch.rand(shape, generator=gen) for shape in ((16, 2, 2, 2), (2, 16, 2, 2), (2, 2, 8, 2), (2, 2, 2, 8))]
    truth = fctn_compose(cores)
    omega = torch.rand(truth.shape, generator=gen) > 0.2
    f4, omega, truth = torch.where(omega, truth, torch.zeros_like(truth)).numpy(), omega.numpy(), truth.numpy()

    def seed():
        return torch.Generator().manual_seed(0)

    calls = {
        "tt_trpca": lambda w: tt_trpca(w(y32), origin=w(x32), max_iter=10, svt_method="gram"),
        "rtrc": lambda w: rtrc(w(y32), w(mask_np), origin=w(x32), max_iter=10, svt_method="gram"),
        "rc_fctn_driver_traffic": lambda w: rc_fctn_driver_traffic(w(y32), w(mask_np), spec.fctn_subdim,
                                                                   origin=w(x32), max_iter=10, svt_method="gram"),
        "trpca_tnn": lambda w: trpca_tnn(w(y32), origin=w(x32), mu=1e-3, max_iter=2),
        "sofia_init": lambda w: sofia_init(w(y32), w(mask_np), 3, spec.sofia_period, origin=w(x32), max_epoch=2,
                                           generator=seed()),
        "sofia_stream_device": lambda w: sofia_stream_device(w(y32), w(mask_np), 3, spec.sofia_period, max_epoch=2,
                                                             generator=seed()),
        "rnc_fctn": lambda w: rnc_fctn(w(f4), 0.1, w(omega), origin=w(truth), max_iter=20, generator=seed()),
    }
    scan, steps_on = sofia._stream_scan, []

    def scan_where(*args):
        steps_on.append(args[0].device.type)
        return scan(*args)

    sofia._stream_scan = scan_where
    try:
        for name, call in calls.items():
            t0 = time.perf_counter()
            got = call(lambda a: a)
            mid = time.perf_counter()
            want = call(lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda())
            torch.cuda.synchronize()
            where = {t.device.type for t in _tensors(got)}
            if name == "sofia_stream_device":  # numpy out, as the reference's; the steps ran on the card
                where, steps_on[:] = set(steps_on), []
            if where != {"cuda"}:
                raise AssertionError(f"phase19 {name} from numpy: results on {where}")
            scale = float(np.abs(f4 if name == "rnc_fctn" else y32).max())
            same = _same_as_tensor_call(f"phase19 {name}", got, want, scale)
            print(f"phase19 {name} from numpy at {'16x16x8x8' if name == 'rnc_fctn' else 'x'.join(map(str, x32.shape))}"
                  f" f32: on cuda; against the call on CUDA tensors: {same}; {mid - t0:.2f} s + "
                  f"{time.perf_counter() - mid:.2f} s (host clock)")
    finally:
        sofia._stream_scan = scan

    r12 = PHASE12_MODE1["res"]
    cfg = dataclasses.replace(PHASE12_MODE1["cfg"], tol=0.0)
    _nccl_one_rank()
    try:
        mesh = make_mesh(device_type="cuda")
        hopper_kernels.reset_launch_counts()
        res = tritd_admm_auto(y32, cfg, mesh, axis_name="slab", origin=x32, init=PHASE12_MODE1["init"])
        torch.cuda.synchronize()
        launches = _launches()
        _tally_pointer(_pointer_launches())
    finally:
        dist.destroy_process_group()
    if res.n_iters != r12.n_iters or launches != {"f32": res.n_iters} or res.o.device.type != "cuda":
        raise AssertionError(f"phase19 tritd_admm_auto: n_iters {res.n_iters} vs {r12.n_iters}, launches {launches}, "
                             f"O on {res.o.device}")
    differ = [f for f in ("a", "b", "c", "o", "e", "err_hist", "rre_hist")
              if not torch.equal(getattr(res, f), getattr(r12, f))]
    if differ:
        raise AssertionError(f"phase19 tritd_admm_auto: {differ} not bitwise phase 12's tritd_admm_sharded")
    print(f"phase19 tritd_admm_auto nccl 1 rank taxi from numpy, tol 0: iters={res.n_iters} launches={launches}; "
          f"A, B, C, O, E, err_hist, rre_hist bitwise phase 12's mode-1 tritd_admm_sharded")
    return launches


# The flat ops.elementwise_block of phase 20 at the taxi shape: (tag, dtypes
# of D, L, E, Y_L, Y_O, compute_dtype, store_dtype, the variant its one
# launch must take). The last mixes dtypes that no variant holds: cast to
# float32, the pure variant, the stores rounded to float16.
FLAT_CASES = (
    ("f32", (torch.float32,) * 5, None, None, "f32"),
    ("f64", (torch.float64,) * 5, None, None, "f64"),
    ("bf16 storage at f32", (torch.bfloat16, torch.float32, *(torch.bfloat16,) * 3), torch.float32, torch.bfloat16,
     "c32_dbf16_sbf16_tbf16"),
    ("bf16/f32 inputs at f32 into f16, the cast route",
     (torch.bfloat16, torch.float32, torch.bfloat16, torch.float32, torch.float32), torch.float32, torch.float16,
     "f32"),
)


def phase20() -> None:
    """The reference-shaped ops.elementwise_block on the card, and numpy input
    to every entry point of tests/torch_numpy_entries.py and to
    init_factors, each against the same call on CUDA tensors."""
    import functools
    import importlib

    from tritd_tpu_torch import ops

    sys.path.insert(0, str(HERE / "tests"))
    from torch_numpy_entries import ENTRIES, X

    for tag, dtypes, cd, sd, variant in FLAT_CASES:
        gen = torch.Generator(device="cuda").manual_seed(20)
        args = [narrow_cast(torch.randn(KERNEL_SHAPES["taxi"], generator=gen, dtype=torch.float64, device="cuda") * 3,
                            dt) for dt in dtypes]
        hopper_kernels.reset_launch_counts()
        got = ops.elementwise_block(*args, *SCALARS, compute_dtype=cd, store_dtype=sd)
        torch.cuda.synchronize()
        launches = _launches()
        if launches != {variant: 1} or len(got) != 6 or any(g.device.type != "cuda" for g in got):
            raise AssertionError(f"phase20 ops.elementwise_block {tag}: launches {launches}, {len(got)} outputs")
        c = cd or functools.reduce(torch.promote_types, dtypes)
        want = hopper_kernels._block_torch(*args, *SCALARS, compute_dtype=c, store_dtype=sd or c)
        wide = [a.to(c) for a in args]
        agree = hopper_kernels.check_narrow_against_plain(wide, (*got, None), want)
        for i in (4, 5):
            torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
        print(f"phase20 ops.elementwise_block {tag} taxi: launches {launches}; outputs {got[0].dtype}, sums "
              f"{got[4].dtype}; held to the plain version: max_abs_err {agree['max_abs_err']:.3e}, narrow elements "
              f"rounded otherwise {agree['flip_share']:.3e}")

    sofia = importlib.import_module("tritd_tpu_torch.baselines.sofia")
    init, init_on = sofia.sofia_init, []

    def init_where(y, *args, **kwargs):
        init_on.append(y.device.type)
        return init(y, *args, **kwargs)

    sofia.sofia_init = init_where
    scale = float(np.abs(X).max())
    try:
        for name, call in ENTRIES.items():
            t0 = time.perf_counter()
            got = call(lambda a: a)
            want = call(lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda())
            torch.cuda.synchronize()
            where = {t.device.type for t in _tensors(got)}
            if name == "baselines.sofia_stream":  # numpy out, as the reference's; the batch init ran on the card
                where, init_on[:] = set(init_on), []
            if where != {"cuda"}:
                raise AssertionError(f"phase20 {name} from numpy: results on {where}")
            same = _same_as_tensor_call(f"phase20 {name}", got, want, scale)
            print(f"phase20 {name} from numpy: on cuda; against the call on CUDA tensors: {same}; "
                  f"{time.perf_counter() - t0:.2f} s (host clock, both calls)")
    finally:
        sofia.sofia_init = init
    got = init_factors(torch.Generator().manual_seed(0), (100, 100, 500), 5, torch.float32)
    want = init_factors(torch.Generator().manual_seed(0), (100, 100, 500), 5, torch.float32, device="cpu")
    if any(g.device.type != "cuda" or not torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("phase20 init_factors: not on the card, or not the CPU draw")
    print(f"phase20 init_factors: on cuda by default, bitwise the same seed's draw on the CPU; "
          f"{len(ENTRIES)} entry points from numpy on the card")


def _route_solve(data, cfg, init, eager: bool, mask=None, origin=None) -> dict:
    """One solve as tritd_admm sets it up, then run_admm on the graph route
    or the eager loop, watched (`_watched`)."""
    dtype = cfg.torch_dtype()
    d = data.to(dtype)
    state = init_state(d, cfg, init)
    norm_d = torch.linalg.vector_norm(d)
    norm_origin = None if origin is None else torch.linalg.vector_norm(origin)
    d = narrow_cast(d, cfg.torch_storage_dtype())
    return _watched(lambda: run_admm(d, state, cfg, mask=mask, origin=origin, norm_d=norm_d, norm_origin=norm_origin,
                                     _eager=eager))


def _watched(call) -> dict:
    """`call()`, a solve, watched: its result, CUDA-event ms, the
    synchronizing calls inside it (torch.cuda.set_sync_debug_mode) and the
    peak MiB. On the graph route also where its time goes: the events' ms up
    to the first replay (the eager first block and the captures), the host
    ms of the captures, the ms from the first replay to the end, and the
    graphs captured."""
    graphs, replays = [], []
    counted = hopper_kernels.CountedGraph

    class Watched(counted):
        def __init__(self, fn, pool, tallies=()):
            super().__init__(fn, pool, tallies)
            graphs.append(self)

        def replay(self):
            if not replays:
                replays.append(torch.cuda.Event(enable_timing=True))
                replays[0].record()
            super().replay()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        hopper_kernels.CountedGraph = Watched
        try:
            start.record()
            res = call()
            end.record()
        finally:
            hopper_kernels.CountedGraph = counted
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the warnings of the synchronizing calls; the mode's one-time notice that it is a
    # prototype also names synchronization
    syncs = sum("called a synchronizing" in str(w.message) for w in seen)
    split = {"graphs": len(graphs)}
    if replays:
        split.update(before_replays_ms=start.elapsed_time(replays[0]), replays_ms=replays[0].elapsed_time(end),
                     capture_host_ms=sum(g.capture_s for g in graphs) * 1e3)
    # Watched's methods hold `graphs`, which holds Watched graphs: a cycle
    # that only the garbage collector would free; free them here
    graphs.clear()
    return {"res": res, "ms": start.elapsed_time(end), "syncs": syncs,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "call_peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20, **split}


def phase21() -> None:
    """The CUDA graph route of the solve loop against the eager loop."""
    x, mask, y, _prov = _taxi()
    v_np, _vspec, _vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    cases = (
        ("taxi f32", y, dataclasses.replace(COMPLETION_TRITD, tol=0.0), None, x),
        ("taxi storage=bf16", y, dataclasses.replace(COMPLETION_TRITD, tol=0.0, storage_dtype="bfloat16"), None, x),
        ("taxi masked f32", y, dataclasses.replace(COMPLETION_TRITD, tol=0.0, masked=True), mask, x),
        ("video highway f32", v, dataclasses.replace(VIDEO_TRITD, tol=0.0), None, None),
    )
    fields = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")
    for tag, data, cfg, dmask, origin in cases:
        init = init_factors(torch.Generator().manual_seed(0), tuple(data.shape), cfg.rank, cfg.torch_dtype())
        for eager in (False, True):  # cuBLAS, cuSOLVER and the capture stream set up outside the timed runs
            _route_solve(data, dataclasses.replace(cfg, max_iter=3), init, eager, dmask, origin)
        runs = {False: [], True: []}
        for eager in (False, True, True, False):
            runs[eager].append(_route_solve(data, cfg, init, eager, dmask, origin))
        graph, eager = runs[False][0]["res"], runs[True][0]["res"]
        dist = {f: float((getattr(graph, f).double() - getattr(eager, f).double()).abs().nan_to_num(0.0).max())
                for f in fields}
        differ = [f for f in fields if not _same_bits(getattr(graph, f), getattr(eager, f))]
        again = [f for f in fields if not _same_bits(getattr(runs[False][1]["res"], f), getattr(graph, f))]
        if differ or again or graph.k != eager.k or graph.mu_l.tobytes() != eager.mu_l.tobytes():
            raise AssertionError(f"phase21 {tag}: the graph route differs from the eager loop in {differ} "
                                 f"(max |diff| {dist}), from its own second run in {again}; k {graph.k} / {eager.k}")
        want_syncs = -(-cfg.max_iter // cfg.unroll) + 1
        syncs = [r["syncs"] for r in runs[False]]
        if any(n != want_syncs for n in syncs):
            raise AssertionError(f"phase21 {tag}: {syncs} synchronizing calls on the graph route, want {want_syncs}")
        ms = {route: [r["ms"] / cfg.max_iter for r in rs] for route, rs in runs.items()}
        replayed = cfg.max_iter - cfg.unroll
        split = "; ".join(f"run {i + 1}: {_split_text(r, replayed)}" for i, r in enumerate(runs[False]))
        print(f"phase21 {tag} ({'x'.join(map(str, data.shape))}, {cfg.max_iter} iterations, unroll {cfg.unroll}): "
              f"graph route {ms[False][0]:.4f} / {ms[False][1]:.4f} ms/iter (events; {split}), eager "
              f"{ms[True][0]:.4f} / {ms[True][1]:.4f}; synchronizing calls a solve graph {syncs} (want "
              f"{want_syncs}), eager {[r['syncs'] for r in runs[True]]}; peak MiB graph "
              f"{runs[False][0]['peak_mib']:.1f}, eager {runs[True][0]['peak_mib']:.1f}; A, B, C, O, E, err_hist, "
              f"rre_hist bitwise equal (max |diff| {max(dist.values()):.1e}); mu {graph.mu_l} after {graph.k}; "
              f"{CARD[0]}", flush=True)


# --- phase 22: a batch's entries in one loop --------------------------------

# the reference's configuration 5 (BASELINE.json: all four CDnet sequences
# batched) and its batched completion row (bench.py:367-415)
PHASE22_VIDEO = ("highway", "sofa", "office", "PETS2006")
PHASE22_TRAFFIC = ("sensor", "network", "taxi", "chicago")
BATCH_FIELDS = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")
# The video batch's float32 err_hist against the serial route's: the batched
# GEMMs round otherwise than one entry's, and on video the difference grows
# to 0.4% of err_hist by iteration 15-21 in one of four entries (a probe on
# an NVIDIA H100 80GB HBM3 at 700 W), past the 2e-3 of the reference's
# sharded tests.
PHASE22_VIDEO_RTOL = 1e-2
# Share of L's and O's elements of a traffic entry that may lie beyond rtol
# 2e-2 of the serial route's, where a pixel passes between L and O when the
# sums are ordered otherwise.
PHASE22_MOVED_SHARE = 1e-4
# A second witness for the video batch: the same four entries in float64 for
# PHASE22_F64_ITERS iterations, where the batched GEMMs' other order of sums
# moves the solve by rounding alone, far below any fault of the batched route:
# every field, L included, within PHASE22_F64_RTOL of the serial route's
# (relative, atol that times the field's largest magnitude).
PHASE22_F64_ITERS = 10
PHASE22_F64_RTOL = 1e-10


def _traffic_batch():
    """The four traffic stand-ins as the reference's batched row takes them
    (bench.py `_load`): README_MISSING_RATIO missing, zero-filled, each
    zero-padded to their common shape (100x100x2016); (truth, data) stacked
    on the CPU in float32, and the unpadded shapes."""
    xs, ys, shapes = [], [], []
    for name in PHASE22_TRAFFIC:
        x, _spec, _prov = load_dataset(name)
        mask = uniform_missing_mask(np.random.default_rng(0), x.shape, README_MISSING_RATIO)
        xs.append(x.astype(np.float32))
        ys.append(np.where(mask, x, 0.0).astype(np.float32))
        shapes.append(x.shape)
    pad = tuple(max(s[i] for s in shapes) for i in range(3))

    def padded(arrays):
        return np.stack([np.pad(a, [(0, pad[i] - a.shape[i]) for i in range(3)]) for a in arrays])

    return padded(xs), padded(ys), shapes


def _batch_route(data, cfg, mesh, origin, serial: bool) -> dict:
    """tritd_admm_batch_sharded on one route, from numpy: the batched loop
    (its `run_admm_batch` call watched, `_watched`) or `_serial=True` (each
    entry's `run_admm` call watched); CUDA events around the whole call, the
    audit, the kernel's launches through each entry point."""
    from tritd_tpu_torch.parallel import sharded_admm, tritd_admm_batch_sharded

    name = "run_admm" if serial else "run_admm_batch"
    real, records = getattr(sharded_admm, name), []
    _release_cached()

    def watched(*args, **kwargs):
        records.append(_watched(lambda: real(*args, **kwargs)))
        return records[-1]["res"]

    hopper_kernels.reset_launch_counts()
    audit: dict = {}
    setattr(sharded_admm, name, watched)
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = tritd_admm_batch_sharded(data, cfg, mesh, origin_batch=origin, audit=audit, _serial=serial)
        end.record()
        torch.cuda.synchronize()
    finally:
        setattr(sharded_admm, name, real)
    return {"res": res, "records": records, "audit": audit, "call_ms": start.elapsed_time(end),
            "launches": _launches(), "pointer": _pointer_launches(),
            "batch": {k[len("elementwise_block_batch["):-1]: v for k, v in hopper_kernels.BATCH_LAUNCHES.items() if v}}


def _stop_tol(err_hists: np.ndarray, max_iter: int) -> tuple[float, list[int]]:
    """A tol under which at least two entries of these tol-0 histories stop
    before max_iter, at different iterations, by the stop rule (|err[k] -
    err[k-1]| < tol * err[k-1], k >= 1; n_iters k + 1), every relative change
    before a stop at least 10% away from tol (so that the routes' rounding
    cannot move a stop; a non-finite change never stops an entry), the
    stops within the first 40 iterations, where the routes are nearest: the
    candidate from 1e-1 down to 1e-7, 24 a decade, that spreads the stops
    widest. Returns it and the stops it gives."""
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(np.diff(err_hists, axis=1)) / err_hists[:, :-1]
    best = None
    for tol in np.logspace(-1, -7, 6 * 24 + 1):
        stops, margin = [], True
        for r in rel:
            hit = np.flatnonzero(r < tol)
            k = int(hit[0]) + 2 if hit.size else max_iter
            stops.append(k)
            near = r[: k - 1] if hit.size else r
            near = near[np.isfinite(near) & (near > 0)]
            margin &= bool(np.all(np.abs(np.log(near / tol)) > np.log(1.1)))
        early = sorted({k for k in stops if k < max_iter})
        if margin and len(early) >= 2 and min(stops) >= 3 and early[-1] <= 40:
            spread = early[-1] - early[0]
            if best is None or spread > best[0]:
                best = (spread, float(tol), stops)
    if best is None:
        raise AssertionError(f"phase22: no tol stops two entries early at different iterations: {rel}")
    return best[1], best[2]


def phase22() -> dict:
    """A batch's entries in one loop on one NCCL rank: tritd_admm_batch_sharded
    on its batched route against `_serial=True`, in turns batched, serial,
    serial, batched. Returns the batched entry's launches of the first
    batched run of each case (the main path)."""
    import torch.distributed as dist

    from tritd_tpu_torch.parallel import make_mesh

    video = [load_dataset(name) for name in PHASE22_VIDEO]
    v = np.stack([x.astype(np.float32) for x, _spec, _prov in video])
    provenance = {prov for _x, _spec, prov in video}
    tx, ty, shapes = _traffic_batch()
    cases = [
        ("video f32 (configuration 5)", v, dataclasses.replace(VIDEO_TRITD, tol=0.0), None, "f32"),
        ("video storage=bf16", v, dataclasses.replace(VIDEO_TRITD, tol=0.0, storage_dtype="bfloat16"), None,
         "c32_dbf16_sbf16_tbf16"),
        ("traffic f32 (batched completion row)", ty, dataclasses.replace(COMPLETION_TRITD, tol=0.0), tx, "f32"),
        (f"video f64 witness ({PHASE22_F64_ITERS} iterations)", v.astype(np.float64),
         dataclasses.replace(VIDEO_TRITD, tol=0.0, dtype="float64", max_iter=PHASE22_F64_ITERS), None, "f64"),
    ]
    total: dict = {}
    _release_cached()
    print(f"phase22 start: {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved", flush=True)
    _nccl_one_rank()
    try:
        mesh = make_mesh(device_type="cuda")
        for route in (False, True):  # NCCL's, cuBLAS's and the captures' set-up stay out of the times
            _batch_route(ty[:, :, :, :50], dataclasses.replace(COMPLETION_TRITD, max_iter=3, tol=0.0), mesh,
                         tx[:, :, :, :50], route)
        case_i = 0
        while case_i < len(cases):
            tag, data, cfg, origin, variant = cases[case_i]
            case_i += 1
            runs = {False: [], True: []}
            for serial in (False, True, True, False):
                runs[serial].append(_batch_route(data, cfg, mesh, origin, serial))
            batched, serial = runs[False][0], runs[True][0]
            nb = data.shape[0]
            n_batch = batched["res"].n_iters.tolist()
            n_serial = serial["res"].n_iters.tolist()
            steps = batched["audit"]["steps"]
            if n_batch != n_serial or n_batch != batched["audit"]["n_iters"] or steps != max(n_batch):
                raise AssertionError(f"phase22 {tag}: n_iters batched {n_batch}, serial {n_serial}, steps {steps}")
            if cfg.tol == 0 and n_batch != [cfg.max_iter] * nb:
                raise AssertionError(f"phase22 {tag}: n_iters {n_batch} at tol 0")
            if cfg.tol:
                early = sorted({k for k in n_batch if k < cfg.max_iter})
                if len(early) < 2:
                    raise AssertionError(f"phase22 {tag}: n_iters {n_batch}: want two entries stopping early at "
                                         f"different iterations")
            # the launches: one of the batched entry an iteration, no single
            # entry; serially every entry's iterations through the pointer entry
            for r in runs[False]:
                if r["batch"] != {variant: steps} or r["launches"] or r["pointer"]:
                    raise AssertionError(f"phase22 {tag}: batched route launched {r['batch']} batched, "
                                         f"{r['launches']} single; want {{{variant!r}: {steps}}} and none")
            for r in runs[True]:
                if r["launches"] != {variant: sum(n_serial)} or r["pointer"] != r["launches"] or r["batch"]:
                    raise AssertionError(f"phase22 {tag}: serial route launched {r['launches']} ({r['pointer']} "
                                         f"through the pointer entry), {r['batch']} batched")
            want_syncs = (steps + (steps < cfg.max_iter) + 1, [n + (n < cfg.max_iter) + 1 for n in n_serial])
            syncs = ([[x["syncs"] for x in r["records"]] for r in runs[False]],
                     [[x["syncs"] for x in r["records"]] for r in runs[True]])
            if any(s != [want_syncs[0]] for s in syncs[0]) or any(s != want_syncs[1] for s in syncs[1]):
                raise AssertionError(f"phase22 {tag}: synchronizing calls batched {syncs[0]}, serial {syncs[1]}; "
                                     f"want {want_syncs}")
            per_iter = batched["audit"]["per_iter"]
            if per_iter["calls"] != 4 or per_iter["words"] != nb * serial["audit"]["per_iter"]["words"]:
                raise AssertionError(f"phase22 {tag}: all_reduce per iteration batched {per_iter}, serial "
                                     f"{serial['audit']['per_iter']}")
            for k, val in batched["batch"].items():
                total[k] = total.get(k, 0) + val
            # each entry against its serial solve: bitwise, else at the
            # float32 tolerances of the reference's sharded tests
            # (tests/test_sharding.py) for solves whose sums are ordered
            # otherwise: histories rtol 2e-3 atol 1e-5 (bf16 storage 2e-2,
            # 1e-4; on video PHASE22_VIDEO_RTOL, and VIDEO_F32_FLOOR near the
            # float32 floor of 4e-5 to 1e-4, as phase 13 holds it), L =
            # TriTD(A, B, C) and O rtol 2e-2 atol 2e-3 max|O| in all but a
            # share PHASE22_MOVED_SHARE of their elements (O not with bf16
            # storage, where a flipped rounding moves an element by a bf16
            # step, as tests/test_torch_parallel.py holds it). On video, where
            # the solves run on at the float32 floor, L and O are printed, not
            # held: there pixels pass between L and O (0.8% of O's elements
            # beyond those limits in a probe), as phase 13 holds its
            # multi-rank video solve by its histories alone.
            # The float64 witness holds every field, L included, at
            # PHASE22_F64_RTOL instead.
            witness = cfg.dtype == "float64"
            floor = VIDEO_F32_FLOOR if origin is None and not witness else None
            bf16 = cfg.storage_dtype is not None
            h_tol = (2e-2, 1e-4) if bf16 else (PHASE22_VIDEO_RTOL if floor else 2e-3, 1e-5)
            bitwise, texts = 0, []
            again = [f for f in BATCH_FIELDS for a, b in ((runs[False][1], batched), (runs[True][1], serial))
                     if not _same_bits(getattr(a["res"], f), getattr(b["res"], f))]
            if again:
                raise AssertionError(f"phase22 {tag}: a route differs from its own second run in {again}")
            for i in range(nb):
                got = {f: getattr(batched["res"], f)[i] for f in BATCH_FIELDS}
                want = {f: getattr(serial["res"], f)[i] for f in BATCH_FIELDS}
                same = [f for f in BATCH_FIELDS if _same_bits(got[f], want[f])]
                bitwise += len(same)
                n = n_batch[i]
                lg, lw = (triple_product(r["a"], r["b"], r["c"]) for r in (got, want))
                if witness:
                    rel = {}
                    for f, g, w in (*((f, got[f], want[f]) for f in BATCH_FIELDS if f not in same), ("L", lg, lw)):
                        scale = float(w.abs().nan_to_num(0.0).max())
                        rel[f] = float((g - w).abs().nan_to_num(0.0).max()) / scale
                        torch.testing.assert_close(g, w, rtol=PHASE22_F64_RTOL, atol=PHASE22_F64_RTOL * scale,
                                                   equal_nan=True, msg=lambda m, f=f: f"phase22 {tag} entry {i} {f}: {m}")
                    texts.append(f"entry {i}: iters={n} max|diff|/max|serial| "
                                 + ", ".join(f"{f} {x:.1e}" for f, x in rel.items()))
                    continue
                for f in ("err_hist", "rre_hist"):
                    if f not in same and (origin is not None or f == "err_hist"):
                        _hist_diff(f"phase22 {tag} entry {i} {f}", got[f].cpu(), want[f].cpu(), n, *h_tol, floor)
                    if not torch.isnan(got[f][n:]).all():
                        raise AssertionError(f"phase22 {tag} entry {i}: {f} not NaN past the stop")
                moved = {}
                for f, g, w in (("L", lg, lw), ("o", got["o"], want["o"]))[: 1 if bf16 else 2]:
                    if not _same_bits(g, w):
                        far = ~torch.isclose(g, w, rtol=2e-2, atol=2e-3 * float(w.abs().max()))
                        moved[f] = float(far.double().mean())
                        if floor is None and moved[f] > PHASE22_MOVED_SHARE:
                            raise AssertionError(f"phase22 {tag} entry {i}: {f} differs from the serial route's in "
                                                 f"{moved[f]:.2e} of its elements, limit {PHASE22_MOVED_SHARE:g}")
                truth = torch.as_tensor(data[i] if origin is None else origin[i], device="cuda")
                if origin is not None:
                    s1, s2, s3 = shapes[i]
                    lg, truth = lg[:s1, :s2, :s3], truth[:s1, :s2, :s3]
                diff = {f: float((got[f].double() - want[f].double()).abs().nan_to_num(0.0).max())
                        for f in BATCH_FIELDS if f not in same}
                texts.append(f"entry {i}: iters={n} rre={float(rre(lg, truth)):.6f}"
                             + (f" max|diff| {', '.join(f'{f} {x:.1e}' for f, x in diff.items())}" if diff else "")
                             + (f"; beyond rtol 2e-2: {', '.join(f'{f} {x:.1e}' for f, x in moved.items())}"
                                if moved else ""))
            ms = {}
            for route, rs in runs.items():
                rows = []
                for r in rs:
                    recs = r["records"]
                    loop_ms = sum(x["ms"] for x in recs)
                    first = sum(x.get("before_replays_ms", 0.0) for x in recs)
                    replays = sum(x.get("replays_ms", 0.0) for x in recs)
                    replayed = (sum(n_serial) - nb) if route else steps - 1
                    peak = max(x["peak_mib"] for x in recs)
                    rows.append(f"{loop_ms / steps if not route else loop_ms / max(n_serial):.4f} ms/iter "
                                f"({first:.2f} ms to the first replay{'s' if route else ''}, then "
                                f"{replays / max(replayed, 1) * (nb if route else 1):.4f} ms/iter; peak "
                                f"{peak:.1f} MiB)")
                ms[route] = rows
            print(f"phase22 nccl 1 rank {tag}: {nb} entries of {'x'.join(map(str, data.shape[1:]))}, "
                  f"{cfg.max_iter} iterations, tol {cfg.tol:g}; n_iters {n_batch}; batched route: "
                  f"{' / '.join(ms[False])}; serial: {' / '.join(ms[True])}; launches batched "
                  f"{batched['batch']} (one an iteration), serial {serial['launches']}; synchronizing calls "
                  f"batched {syncs[0]}, serial {syncs[1]}; all_reduce/iter {per_iter}; {bitwise} of "
                  f"{nb * len(BATCH_FIELDS)} fields bitwise the serial route's; " + "; ".join(texts)
                  + f"; {CARD[0]}", flush=True)
            if tag.startswith("traffic f32 (batched"):
                # the early stop: a tol under which two entries stop at
                # different iterations, from these tol-0 histories
                tol, stops = _stop_tol(batched["res"].err_hist.cpu().double().numpy(), cfg.max_iter)
                print(f"phase22 early-stop tol {tol:.3e} from the tol-0 histories: entries stop after {stops}")
                cases.append((f"traffic f32 early stop (tol {tol:.3e})", ty,
                              dataclasses.replace(COMPLETION_TRITD, tol=tol), tx, "f32"))
            # this case's results leave the card before the next case's runs
            runs = batched = serial = got = want = lg = lw = truth = None
            print(f"phase22 after {tag}: {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated", flush=True)
        print(f"phase22 data: video stand-ins ({', '.join(sorted(provenance))}), traffic padded from {shapes}")
    finally:
        dist.destroy_process_group()
    return total


# --- phase 23: the other solve loops on their graph route -------------------

PHASE23_EVERY = 25
PHASE23_CKPT_ITERS = 50
RESULT_FIELDS = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")


@contextlib.contextmanager
def _saves_apart(saves: list):
    """Inside, each checkpoint save of tritd_admm_checkpointed runs with the
    sync debug mode off (its reads to the host are the save's, not the
    loop's) between two CUDA events; `saves` gets (events ms, host s) of
    each."""
    from tritd_tpu_torch.solvers import checkpointed

    real = checkpointed.save_state

    def save(path, state):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        try:
            return real(path, state)
        finally:
            end.record()
            end.synchronize()
            saves.append((start.elapsed_time(end), time.perf_counter() - t0))
            torch.cuda.set_sync_debug_mode(mode)

    checkpointed.save_state = save
    try:
        yield saves
    finally:
        checkpointed.save_state = real


def _routes_differ(graph, eager) -> list:
    return [f for f in RESULT_FIELDS if not _same_bits(getattr(graph, f), getattr(eager, f))]


# The `graphs` argument of a solve loop's private function on each route.
ROUTE_GRAPHS = {"graphs": True, "eager": None}


def _split_text(r: dict, replayed: int) -> str:
    """One graph-route run's time split: to the first replay, then each
    replayed iteration's."""
    return (f"{r['before_replays_ms']:.2f} ms to the first replay ({r['graphs']} captures, "
            f"{r['capture_host_ms']:.2f} ms of host), then {r['replays_ms'] / replayed:.4f} ms/iter")


def phase23() -> None:
    """The solve loops other than tritd_admm's on the graph route against
    their eager loops: tritd_admm_checkpointed (taxi f32, every=25, 50
    iterations: one loop for the call, two captures), tritd_admm_outlier at
    highway, tritd_als and tritd_mals at taxi (100 iterations each); then
    the solve methods "pinv" and "lstsq", which take the eager loop in
    tritd_admm and in the sharded and batched sharded solves on one NCCL
    rank."""
    from tritd_tpu_torch.solvers import als, checkpointed, outlier

    _release_cached()
    x, _mask, y, _prov = _taxi()
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    init = init_factors(gen(), tuple(y.shape), COMPLETION_TRITD.rank, torch.float32)

    # the checkpointed segments: one graph run, one eager, each with its two saves
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=PHASE23_CKPT_ITERS, tol=0.0)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for eager in (False, True):
            saves: list = []
            ckpt = os.path.join(tmp, str(eager))
            with _saves_apart(saves):
                hopper_kernels.reset_launch_counts()
                # the graph route through the entry point, the eager loop through `_solve(..., graphs=None)`
                runs[eager] = _watched(lambda: checkpointed._solve(y, cfg, ckpt, PHASE23_EVERY, init, None, True,
                                                                   graphs=None) if eager else
                                       checkpointed.tritd_admm_checkpointed(y, cfg, ckpt, every=PHASE23_EVERY,
                                                                            init=init))
            runs[eager].update(saves=saves, launches=_launches(), pointer=_pointer_launches(),
                               steps=sorted(os.listdir(ckpt)))
        files_differ = []
        for step in runs[False]["steps"]:
            if step in runs[True]["steps"]:
                with np.load(os.path.join(tmp, "False", step)) as g, np.load(os.path.join(tmp, "True", step)) as e:
                    files_differ += [(step, k) for k in e.files if g[k].tobytes() != e[k].tobytes()]
    graph, eager = runs[False], runs[True]
    segments = -(-cfg.max_iter // PHASE23_EVERY)
    differ = _routes_differ(graph["res"], eager["res"])
    want_syncs = cfg.max_iter + segments
    if (differ or files_differ or graph["res"].n_iters != cfg.max_iter or graph["graphs"] != 2
            or graph["syncs"] != want_syncs or graph["steps"] != eager["steps"] or len(graph["steps"]) != segments
            or graph["launches"] != {"f32": cfg.max_iter} or graph["pointer"] != graph["launches"]):
        raise AssertionError(
            f"phase23 checkpointed: graph route differs from the eager loop in {differ}, its checkpoints in "
            f"{files_differ}; n_iters "
            f"{graph['res'].n_iters}; {graph['graphs']} captures (want 2); {graph['syncs']} synchronizing calls "
            f"(want {want_syncs}); saves {graph['steps']} / {eager['steps']}; launches {graph['launches']}, "
            f"through the pointer entry {graph['pointer']}")
    # every save comes after the first replay (iteration 2): take them out of both spans
    loop_ms = {route: (r["ms"] - sum(ms for ms, _s in r["saves"])) / cfg.max_iter for route, r in runs.items()}
    graph["replays_ms"] -= sum(ms for ms, _s in graph["saves"])
    print(f"phase23 checkpointed taxi f32 (every {PHASE23_EVERY}, {cfg.max_iter} iterations, {segments} saves): "
          f"graph route {loop_ms[False]:.4f} ms/iter without the saves (events; "
          f"{_split_text(graph, cfg.max_iter - 1)}), eager {loop_ms[True]:.4f}; saves ms (events) graph "
          f"{[round(ms, 1) for ms, _s in graph['saves']]}, eager {[round(ms, 1) for ms, _s in eager['saves']]}; "
          f"{graph['graphs']} captures for the call; synchronizing calls graph {graph['syncs']} (want "
          f"{want_syncs}, the saves apart), eager {eager['syncs']}; launches {graph['launches']} all through the "
          f"pointer entry; A, B, C, O, E, err_hist and the checkpoint files bitwise the eager loop's; {CARD[0]}",
          flush=True)
    runs = graph = eager = None

    # the outlier solver, ALS and MALS, in turns graph, eager, eager, graph
    v_np, _vspec, _vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    init_v = init_factors(gen(), tuple(v.shape), OutlierConfig().rank, torch.float32)
    loops = (
        ("outlier highway 240x320x300", OutlierConfig(tol=0.0), 2,
         lambda c, route: outlier._outlier_run(v, c, init_v, None, ROUTE_GRAPHS[route])),
        ("als taxi 100x100x500", TriTDConfig(tol=0.0), 1,
         lambda c, route: als._als_run(x, c, False, init, None, ROUTE_GRAPHS[route])),
        ("mals taxi 100x100x500", TriTDConfig(), 1,
         lambda c, route: als._als_run(x, c, True, init, None, ROUTE_GRAPHS[route])),
    )
    for tag, c, captures, solve in loops:
        for route in ("graphs", "eager"):  # cuBLAS's, cuSOLVER's and the side stream's set-up out of the times
            solve(dataclasses.replace(c, max_iter=3), route)
        runs = {"graphs": [], "eager": []}
        for route in ("graphs", "eager", "eager", "graphs"):
            runs[route].append(_watched(lambda: solve(c, route)))
        graph, eager = runs["graphs"][0], runs["eager"][0]
        differ = _routes_differ(graph["res"], eager["res"])
        again = _routes_differ(runs["graphs"][1]["res"], graph["res"])
        want_syncs = 1 if tag.startswith("mals") else c.max_iter
        syncs = [r["syncs"] for r in runs["graphs"]]
        if (differ or again or graph["res"].n_iters != c.max_iter or any(r["graphs"] != captures for r in
                                                                          runs["graphs"])
                or any(n != want_syncs for n in syncs)):
            raise AssertionError(f"phase23 {tag}: the graph route differs from the eager loop in {differ}, from its "
                                 f"own second run in {again}; n_iters {graph['res'].n_iters}; captures "
                                 f"{[r['graphs'] for r in runs['graphs']]} (want {captures}); synchronizing calls "
                                 f"{syncs} (want {want_syncs})")
        ms = {route: [r["ms"] / c.max_iter for r in rs] for route, rs in runs.items()}
        split = "; ".join(f"run {i + 1}: {_split_text(r, c.max_iter - 1)}" for i, r in enumerate(runs["graphs"]))
        print(f"phase23 {tag} ({c.max_iter} iterations, tol {c.tol:g}): graph route {ms['graphs'][0]:.4f} / "
              f"{ms['graphs'][1]:.4f} ms/iter (events; {split}), eager {ms['eager'][0]:.4f} / "
              f"{ms['eager'][1]:.4f}; synchronizing calls a solve graph {syncs} (want {want_syncs}), eager "
              f"{[r['syncs'] for r in runs['eager']]}; peak MiB graph {graph['peak_mib']:.1f}, eager "
              f"{eager['peak_mib']:.1f}; factors, O and err_hist bitwise the eager loop's; {CARD[0]}", flush=True)
        runs = graph = eager = None

    # the solve methods whose torch forms cannot be captured take the eager
    # loop: tritd_admm, and on one NCCL rank the sharded solve and the
    # batched sharded one (taxi and its mirror image), whose collectives the
    # graph route would capture
    import torch.distributed as dist

    from tritd_tpu_torch.parallel import make_mesh, tritd_admm_batch_sharded, tritd_admm_sharded

    pair = torch.stack([y, y.flip(0)])
    _nccl_one_rank()
    try:
        mesh = make_mesh(device_type="cuda")
        for method in ("pinv", "lstsq"):
            c = dataclasses.replace(COMPLETION_TRITD, max_iter=3, tol=0.0, solve_method=method)
            for tag, solve, want in (
                    ("tritd_admm", lambda: tritd_admm(y, c, init=init), ({"f32": 3}, {})),
                    ("tritd_admm_sharded", lambda: tritd_admm_sharded(y, c, mesh, init=init), ({"f32": 3}, {})),
                    ("tritd_admm_batch_sharded", lambda: tritd_admm_batch_sharded(pair, c, mesh),
                     ({}, {"elementwise_block_batch[f32]": 3}))):
                hopper_kernels.reset_launch_counts()
                r = _watched(solve)
                launches, pointer = _launches(), _pointer_launches()
                batch = {k: v for k, v in hopper_kernels.BATCH_LAUNCHES.items() if v}
                n = r["res"].n_iters
                n = n.tolist() if isinstance(n, torch.Tensor) else [n]
                route = "graph route" if r["graphs"] else "eager loop"
                if r["graphs"] or set(n) != {3} or (launches, batch) != want or pointer:
                    raise AssertionError(f"phase23 {tag} solve_method={method}: {route} ({r['graphs']} captures), "
                                         f"n_iters {n}, launches {launches}, batched {batch}, through the pointer "
                                         f"entry {pointer}; want {want}")
                err = r["res"].err_hist.reshape(-1, 3)
                if not torch.isfinite(err).all():
                    raise AssertionError(f"phase23 {tag} solve_method={method}: err_hist {err.tolist()}")
                print(f"phase23 {tag} solve_method={method} taxi{' x2' if len(n) > 1 else ''}: the {route} (no "
                      f"capture; admm.UNCAPTURED_METHODS), {r['ms'] / 3:.4f} ms/iter (events), launches "
                      f"{launches or batch} by value, err_hist {err.tolist()}", flush=True)
                r = None
    finally:
        dist.destroy_process_group()


# SOFIA's kernels (ops/sofia_kernels.py): the datasets of the slice, at
# their full widths, whose main-path shapes the checks of phase 9 take, and
# the reference functions each kernel stands for (mode3_sweep: the whole
# mode-3 step, its systems and the scan of its sweep at :175).
SOFIA_DATASETS = ("taxi", "highway", "network")
SOFIA_REPLACES = {"pinv_rows": "tritd_tpu/baselines/sofia.py:69", "mode3_sweep": "tritd_tpu/baselines/sofia.py:121"}
SOFIA_TAGS = {torch.float32: "f32", torch.float64: "f64"}
# pinv_rows against torch's SVD pinv: each row within PINV_EPS_FACTOR * r eps
# of its largest value times the condition of the eigenvalues its gram keeps
# (two backward-stable solves of one system differ by about that); the
# mode-3 step and the sweep alone within SWEEP_EPS_FACTOR eps of the largest
# value (one chain of products and sums in two orders)
PINV_EPS_FACTOR = 64
SWEEP_EPS_FACTOR = 256
SOFIA_PLAIN_REPS = 4  # turns of the plain sweep, a Python loop over the rows
# the chain bound of the mode-3 step: n3 rows of r + 1 dependent FMAs, at
# these latencies (cycles; assumed, not measured) over the SM clock
FMA_LATENCY_CYCLES = {torch.float32: 4, torch.float64: 8}


def _sofia_problem(name: str, dtype, seed: int = 0):
    """The kernels' inputs at a dataset's main-path shapes, from its stand-in
    with 10% missing and uniform factors of rank SOFIA_PRESET.rank: the
    mode-1 and mode-2 right-hand sides and grams (mode-1 slice 0 all
    missing, a zero gram; slice 1 observed at one entry, a rank-one gram)
    and the mode-3 step's old rows, right-hand sides and grams; and the
    period."""
    from tritd_tpu_torch.baselines import sofia

    x_np, spec, _prov = load_dataset(name)
    mask = uniform_missing_mask(np.random.default_rng(seed), x_np.shape, README_MISSING_RATIO)
    mask[0] = False
    mask[1] = False
    mask[1, 0, 0] = True
    om = torch.as_tensor(mask, device="cuda").to(dtype)
    y = torch.as_tensor(np.where(mask, x_np, 0.0), device="cuda").to(dtype)
    gen = torch.Generator().manual_seed(seed)
    u1, u2, u3 = (torch.rand((n, SOFIA_PRESET.rank), generator=gen, dtype=torch.float64).to("cuda", dtype)
                  for n in x_np.shape)
    kr = sofia._khatri_rao
    rows = [sofia._masked_row_systems(y, om, kr(u2, u3)),
            sofia._masked_row_systems(y.transpose(0, 1).contiguous(), om.transpose(0, 1).contiguous(), kr(u1, u3))]
    rhs_base, gram_base = sofia._masked_row_systems(torch.movedim(y, 2, 0).contiguous(),
                                                    torch.movedim(om, 2, 0).contiguous(), kr(u1, u2))
    return rows, (u3, rhs_base.contiguous(), gram_base.contiguous()), spec.sofia_period


def _sofia_bound(kind: str, n: int, r: int, dtype) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for one call on n
    systems of rank r, its inputs read and its output written once (pinv:
    rhs, the grams, the rows out; the mode-3 step: the old rows, rhs_base,
    the grams, the rows out), against the least arithmetic any method
    needs: a pinv r^3 + 4 r^2 a system (one factorization's worth and the
    two products), a mode-3 row r^3 + 2 r^2 + 8 r (an inverse, the row
    product, the right-hand side and the coupling)."""
    size = torch.empty((), dtype=dtype).element_size()
    per = (2 * r + r * r) if kind == "pinv_rows" else (3 * r + r * r)
    by_bytes = n * per * size / PEAK_BYTES_PER_S * 1e3
    ops = n * ((r**3 + 4 * r * r) if kind == "pinv_rows" else (r**3 + 2 * r * r + 8 * r))
    by_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _sm_clocks() -> tuple[float, float]:
    """(clocks.sm, clocks.max.sm) in MHz, as nvidia-smi reads them now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.splitlines()[0]
    now, top = (float(v) for v in out.split(","))
    return now, top


def _chain_bound_ms(n3: int, r: int, dtype, mhz: float) -> float:
    """The least time of the mode-3 step's dependent path: n3 rows of r + 1
    FMA latencies at `mhz`."""
    return n3 * (r + 1) * FMA_LATENCY_CYCLES[dtype] / (mhz * 1e6) * 1e3


def _check_pinv(tag, rhs, gram, zero_gram: bool) -> tuple[float, float]:
    """pinv_rows against its plain version on these rows, of which some
    grams are all zero if `zero_gram`: (max abs error, the largest error
    over its limit's eps * condition * scale)."""
    from tritd_tpu_torch.ops import sofia_kernels

    dtype, r = gram.dtype, gram.shape[-1]
    eps = torch.finfo(dtype).eps
    rtol = 10.0 * r * eps
    got, want = sofia_kernels.pinv_rows(rhs, gram, rtol), sofia_kernels.pinv_rows_torch(rhs, gram, rtol)
    torch.cuda.synchronize()
    zero = (gram == 0).flatten(1).all(1)
    if bool(zero.any()) != zero_gram or not (got[zero] == 0).all() or not (want[zero] == 0).all():
        raise AssertionError(f"{tag}: the all-zero grams' rows are not exactly zero: {got[zero]}")
    lam = torch.linalg.eigvalsh(gram.double()).abs()
    kept = torch.where(lam > rtol * lam.amax(-1, keepdim=True), lam, torch.full_like(lam, float("inf")))
    cond = torch.where(torch.isfinite(kept.amin(-1)), lam.amax(-1) / kept.amin(-1), torch.ones_like(lam[:, 0]))
    err = (got - want).abs().amax(-1).double()
    scale = want.abs().amax(-1).double()
    ratio = float((err / (eps * cond * scale.clamp(min=1e-300))).max())
    if not ratio <= PINV_EPS_FACTOR * r:
        raise AssertionError(f"{tag}: a row {ratio:.1f} eps x condition x scale from torch's pinv, limit "
                             f"{PINV_EPS_FACTOR * r}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: non-finite rows")
    return float(err.max()), ratio


def _check_mode3(tag, args, m) -> tuple[float, tuple, float]:
    """mode3_sweep against its plain version, and the gauss_seidel_sweep kernel alone on
    the systems of the same inputs against the same rows (the plain version
    is gauss_seidel_sweep_torch on those systems); one mode3_sweep launch a
    call. Returns the mode-3 step's max abs error, those systems (rhs0,
    inv) and the sweep's max abs error."""
    from tritd_tpu_torch.ops import sofia_kernels

    lam1, lam2 = SOFIA_PRESET.lambda1, SOFIA_PRESET.lambda2
    hopper_kernels.reset_launch_counts()
    got = sofia_kernels.mode3_sweep(*args, lam1, lam2, m)
    launched = {k: n for k, n in hopper_kernels.SOFIA_LAUNCHES.items() if n}
    if launched != {f"mode3_sweep[{SOFIA_TAGS[args[0].dtype]}]": 1}:
        raise AssertionError(f"{tag}: one mode3_sweep launch a call, counted {launched}")
    want = sofia_kernels.mode3_sweep_torch(*args, lam1, lam2, m)
    rhs0, inv = sofia_kernels._mode3_systems(*args, lam1, lam2, m)
    old = sofia_kernels.gauss_seidel_sweep(rhs0, inv, lam1, lam2, m)
    torch.cuda.synchronize()
    scale, limit = float(want.abs().max()), SWEEP_EPS_FACTOR * torch.finfo(rhs0.dtype).eps
    errs = {}
    for name, x in (("mode3_sweep", got), ("gauss_seidel_sweep", old)):
        errs[name] = float((x - want).abs().max())
        if not (errs[name] <= limit * scale and torch.isfinite(x).all()):
            raise AssertionError(f"{tag} {name}: max |error| {errs[name]:.3e} of {scale:.3e}, limit "
                                 f"{SWEEP_EPS_FACTOR} eps")
    return errs["mode3_sweep"], (rhs0, inv), errs["gauss_seidel_sweep"]


def _sofia_kernels() -> dict:
    """Each of SOFIA's kernels against its plain version on the card, at the
    shapes the main path gives it at taxi, highway and network, in float32
    and float64 (phase 9); timed beside its bound, its plain version and,
    for pinv_rows, torch.linalg.pinv and the row product (the one PyTorch
    call for its function) and its one-pass floor (the same count of
    diagonal grams, which one Jacobi pass ends), at each shape; the mode-3
    step beside its chain bound, the gauss_seidel_sweep kernel alone on its
    systems and, at taxi, the split step (those systems in torch, then that
    kernel) and the
    plain version (a Python loop of the rows). Returns the taxi records of
    the kernels line, by (name, dtype tag)."""
    from tritd_tpu_torch.ops import sofia_kernels

    records = {}
    lam1, lam2 = SOFIA_PRESET.lambda1, SOFIA_PRESET.lambda2
    for dtype in (torch.float32, torch.float64):
        tag = SOFIA_TAGS[dtype]
        for name in SOFIA_DATASETS:
            rows, args, m = _sofia_problem(name, dtype)
            n3, r = args[0].shape
            for mode, (rhs, gram) in enumerate(rows, 1):
                label = f"phase9 pinv_rows[{tag}] {name} mode {mode} ({gram.shape[0]} grams, r={r})"
                max_abs, ratio = _check_pinv(label, rhs, gram, zero_gram=mode == 1)
                rtol = 10.0 * r * torch.finfo(dtype).eps
                diag = torch.diag_embed(torch.diagonal(gram, dim1=1, dim2=2) + 1.0).contiguous()
                plain = lambda rhs=rhs, gram=gram, rtol=rtol: sofia_kernels.pinv_rows_torch(rhs, gram, rtol)  # noqa: E731
                calls = {"kernel": lambda rhs=rhs, gram=gram, rtol=rtol: sofia_kernels.pinv_rows(rhs, gram, rtol),
                         "floor": lambda rhs=rhs, diag=diag, rtol=rtol: sofia_kernels.pinv_rows(rhs, diag, rtol),
                         "library": lambda gram=gram, rhs=rhs, rtol=rtol: torch.bmm(
                             rhs[:, None, :], torch.linalg.pinv(gram, rtol=rtol))}
                ms, plain_ms, _copy, _host = _time_pair(plain, calls, 1 << 20, reps=8)
                bound_ms, bound_by = _sofia_bound("pinv_rows", gram.shape[0], r, dtype)
                print(f"{label}: max_abs_err={max_abs:.3e} (worst row {ratio:.2f} eps x condition x scale, limit "
                      f"{PINV_EPS_FACTOR * r}){', the zero gram row exactly 0' if mode == 1 else ''}; "
                      f"kernel={ms['kernel'] * 1e3:.1f} us (one-pass floor {ms['floor'] * 1e3:.1f} us) "
                      f"plain={plain_ms * 1e3:.1f} us torch.linalg.pinv+bmm={ms['library'] * 1e3:.1f} us "
                      f"bound={bound_ms * 1e3:.4f} us by {bound_by} (events)", flush=True)
                if name == "taxi" and mode == 1:
                    records["pinv_rows", tag] = {"max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": plain_ms,
                                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                                 "library_ms": ms["library"], "floor_ms": ms["floor"]}
            label = f"phase9 mode3_sweep[{tag}] {name} (n3={n3}, r={r}, m={m})"
            max_abs, (rhs0, inv), old_err = _check_mode3(label, args, m)
            calls = {"kernel": lambda args=args, m=m: sofia_kernels.mode3_sweep(*args, lam1, lam2, m),
                     "old": lambda rhs0=rhs0, inv=inv, m=m: sofia_kernels.gauss_seidel_sweep(rhs0, inv, lam1, lam2, m)}
            plain = None
            if name == "taxi":
                calls["old_step"] = lambda args=args, m=m: sofia_kernels.gauss_seidel_sweep(
                    *sofia_kernels._mode3_systems(*args, lam1, lam2, m), lam1, lam2, m)
                plain = lambda args=args, m=m: sofia_kernels.mode3_sweep_torch(*args, lam1, lam2, m)  # noqa: E731
            ms, plain_ms, _copy, host = _time_pair(plain, calls, 1 << 20, reps=SOFIA_PLAIN_REPS if plain else 8)
            mhz, top_mhz = _sm_clocks()
            bound_ms, bound_by = _sofia_bound("mode3_sweep", n3, r, dtype)
            chain_ms = _chain_bound_ms(n3, r, dtype, top_mhz)
            print(f"{label}: max_abs_err={max_abs:.3e} (limit {SWEEP_EPS_FACTOR} eps of max |row|; the sweep kernel "
                  f"{old_err:.3e}); kernel={ms['kernel'] * 1e3:.1f} us ({ms['kernel'] * 1e3 / n3:.4f} us a row), "
                  f"one launch; the sweep kernel alone on its systems {ms['old'] * 1e3:.1f} us"
                  + (f", the split step (its systems in torch, then that kernel) {ms['old_step'] * 1e3:.1f} us of the card "
                     f"({host['old_step'] * 1e3:.1f} us of host enqueue; the kernel's {host['kernel'] * 1e3:.1f}), "
                     f"plain={plain_ms * 1e3:.1f} us" if plain else "")
                  + f"; bound={bound_ms * 1e3:.4f} us by {bound_by}, chain bound {chain_ms * 1e3:.2f} us ({n3} x "
                  f"{r + 1} FMAs of {FMA_LATENCY_CYCLES[dtype]} cycles at clocks.max.sm {top_mhz:.0f} MHz; "
                  f"clocks.sm {mhz:.0f} MHz read after) (events)", flush=True)
            if name == "taxi":
                records["mode3_sweep", tag] = {"max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": plain_ms,
                                               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                                               "sweep_kernel_ms": ms["old"], "split_step_ms": ms["old_step"]}
    return records


SOFIA_EPOCHS = {"taxi": 10, "highway": 2}  # highway's 2 epochs: a depth cut
SOFIA_ALS_ITERS = 20  # the ALS loop timed alone, tol 0
SOFIA_INIT_RTOL = 1e-3  # float32 on the card against float64 on the CPU: err_hist (tests/test_torch_cuda.py's)
SOFIA_SWEEP_TOL = (1e-3, 1e-4)  # the sweep, float32 on the card against float64 on the CPU (rtol, atol)
SOFIA_STREAM_RTOL = 1e-3  # the stream, the same, atol SOFIA_STREAM_RTOL * max |X|
SOFIA_CAPTURES = 3  # most graphs a sofia_init call may capture: the ALS start, an ALS iteration, the epoch step
SOFIA_WIDE_RANK, SOFIA_WIDE_EPOCHS = 4, 2  # the graph route above r = 3: taxi, 2 epochs (a depth cut)
SOFIA_MAIN_KERNELS = ("pinv_rows", "mode3_sweep")


def _sofia_data(name: str):
    """(y, mask, truth, period): taxi with 10% missing, highway fully observed."""
    if name == "taxi":
        x, mask, y, _prov = _taxi()
    else:
        x_np, _spec, _prov = load_dataset(name)
        x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
        mask, y = torch.ones_like(x, dtype=torch.bool), x
    return y, mask, x, load_dataset(name)[1].sofia_period


def _sofia_init_route(name: str, graphs: bool, dtype=torch.float32, rank: int | None = None,
                      epochs: int | None = None) -> dict:
    """sofia_init's device form at a dataset, SOFIA_PRESET (or another
    rank), its epochs, from a seeded uniform init, on one route, watched
    (`_watched`)."""
    from tritd_tpu_torch.baselines import sofia

    y, mask, x, m = _sofia_data(name)
    p = SOFIA_PRESET
    rank = rank or p.rank
    init = tuple(torch.rand((n, rank), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
                 for n in y.shape)
    return _watched(lambda: sofia._init_run(y.to(dtype), mask, rank, m, p.lambda1, p.lambda2, p.lambda3,
                                            x.to(dtype), epochs or SOFIA_EPOCHS[name], p.tol, 300, None, init,
                                            graphs))


def _same_sofia(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_sofia(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or a is None:
        return (a is None and b is None) or np.array_equal(a, b, equal_nan=True)
    return _same_bits(a, b)


def phase24() -> dict:
    """SOFIA's three device loops (the ALS and epoch while_loops of
    sofia_init and the stream's scan) on the CUDA graph route against the
    same device programs without graphs; returns the main path's launches
    of each SOFIA kernel, by (name, dtype tag)."""
    from tritd_tpu_torch.baselines import sofia

    p = SOFIA_PRESET
    counts = hopper_kernels.SOFIA_LAUNCHES
    y, mask, x, m = _sofia_data("taxi")
    init = tuple(torch.rand((n, p.rank), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
                 for n in y.shape)
    kw = dict(r=p.rank, m=m, lam1=p.lambda1, lam2=p.lambda2, lam3=p.lambda3, tol=p.tol, u_init=init)
    # the main path: the public entry point on its graph route, float32
    # (10 epochs) and float64 (2), the counts zeroed just before; neither
    # the plain systems (`_mode3_systems`, torch.roll) nor the sweep kernel
    # may run on it
    from tritd_tpu_torch.ops import sofia_kernels

    plain_calls = {"_mode3_systems": 0, "torch.roll": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            plain_calls[key] += 1
            return fn(*args, **kwargs)
        return call

    systems, roll = sofia_kernels._mode3_systems, torch.roll
    sofia_kernels._mode3_systems, torch.roll = counted("_mode3_systems", systems), counted("torch.roll", roll)
    try:
        for key in counts:
            counts[key] = 0
        main = sofia.sofia_init(y, mask, origin=x, max_epoch=SOFIA_EPOCHS["taxi"], **kw)
        sofia.sofia_init(y.double(), mask, origin=x.double(), max_epoch=2, dtype=torch.float64, **kw)
    finally:
        sofia_kernels._mode3_systems, torch.roll = systems, roll
    launches = {(key.split("[")[0], key.split("[")[1][:-1]): n for key, n in counts.items()}
    on_path = {key: n for key, n in launches.items() if key[0] in SOFIA_MAIN_KERNELS}
    if not all(on_path.values()) or any(n for key, n in launches.items() if key not in on_path) or any(
            plain_calls.values()):
        raise AssertionError(f"phase24: the main path's SOFIA launches {counts}, plain calls {plain_calls}")
    if any(launches["pinv_rows", tag] != 2 * launches["mode3_sweep", tag] for tag in ("f32", "f64")):
        raise AssertionError(f"phase24: not two pinv_rows launches a mode3_sweep launch: {counts}")
    print(f"phase24 main path: sofia_init taxi f32 ({len(main[3])} epochs) and f64 (2 epochs) on the graph "
          f"route: launches {counts}: one mode3_sweep launch an ALS iteration (beside two pinv_rows), no "
          f"gauss_seidel_sweep, {plain_calls}", flush=True)

    for name in ("taxi", "highway"):
        runs = {}
        for turn, graphs in enumerate((True, False, False, True)):
            runs.setdefault(graphs, []).append(_sofia_init_route(name, graphs))
        graph, eager = runs[True], runs[False]
        for r_ in (*graph[1:], *eager):
            if not _same_sofia(r_["res"], graph[0]["res"]):
                raise AssertionError(f"phase24 sofia_init {name}: the routes' factors, X, O or err_hist differ")
        if name == "taxi" and not _same_sofia(graph[0]["res"], main):
            raise AssertionError("phase24 sofia_init taxi: the device form differs from the public entry point")
        n_ep = len(graph[0]["res"][3])
        for g in graph:
            if g["graphs"] > SOFIA_CAPTURES:
                raise AssertionError(f"phase24 sofia_init {name}: {g['graphs']} captures, at most {SOFIA_CAPTURES}")
        print(f"phase24 sofia_init {name} ({n_ep} epochs, r={p.rank}, m={_sofia_data(name)[3]}): graph route "
              f"bitwise the route without graphs (factors, X, O, err_hist; 2 runs each); graph "
              f"{[round(g['ms'] / n_ep, 3) for g in graph]} ms an epoch ({graph[0]['graphs']} captures a call, "
              f"{graph[-1]['syncs']} synchronizing calls, {graph[-1]['before_replays_ms']:.2f} ms to the first replay, "
              f"{graph[-1]['capture_host_ms']:.2f} ms of it the captures' host time), eager "
              f"{[round(e['ms'] / n_ep, 3) for e in eager]} ms an epoch ({eager[-1]['syncs']} synchronizing calls); "
              f"peak {graph[-1]['peak_mib']:.1f} / {eager[-1]['peak_mib']:.1f} MiB; err_hist "
              f"{np.round(graph[0]['res'][3], 6).tolist()} ({CARD[0]})", flush=True)

    # an ALS iteration, the loop alone (tol 0): one mode3_sweep launch an
    # iteration on either route
    u = tuple(torch.as_tensor(v, device="cuda").float() for v in init)
    hopper_kernels.reset_launch_counts()
    als = {g: [_watched(lambda g=g: sofia._als_loop(y, mask, *u, m, p.lambda1, p.lambda2, SOFIA_ALS_ITERS, 0.0,
                                                    graphs=g)) for _ in range(2)] for g in (True, False)}
    if not all(_same_sofia(r_["res"], als[True][0]["res"]) for r_ in (*als[True], *als[False])):
        raise AssertionError("phase24 sofia ALS loop: the routes differ")
    want = {key: 0 for key in counts}
    want.update({"mode3_sweep[f32]": 4 * SOFIA_ALS_ITERS, "pinv_rows[f32]": 8 * SOFIA_ALS_ITERS})
    if counts != want:
        raise AssertionError(f"phase24 sofia ALS loop: launches {counts}, want {want}")
    print(f"phase24 sofia ALS loop taxi, {SOFIA_ALS_ITERS} iterations, tol 0: graph "
          f"{[round(r_['ms'] / SOFIA_ALS_ITERS, 4) for r_ in als[True]]} ms an iteration "
          f"({_split_text(als[True][-1], SOFIA_ALS_ITERS - 1)}, {als[True][-1]['syncs']} synchronizing calls), eager "
          f"{[round(r_['ms'] / SOFIA_ALS_ITERS, 4) for r_ in als[False]]} ({als[False][-1]['syncs']} synchronizing "
          f"calls), bitwise; one mode3_sweep launch an iteration ({counts['mode3_sweep[f32]']} in 4 x "
          f"{SOFIA_ALS_ITERS})", flush=True)

    # above r = 3 the mode-3 step is the kernel too: the graph route at r = 4
    runs = {}
    for graphs in (True, False, False, True):
        runs.setdefault(graphs, []).append(_sofia_init_route("taxi", graphs, rank=SOFIA_WIDE_RANK,
                                                             epochs=SOFIA_WIDE_EPOCHS))
    graph, eager = runs[True], runs[False]
    if not all(_same_sofia(r_["res"], graph[0]["res"]) for r_ in (*graph[1:], *eager)):
        raise AssertionError(f"phase24 sofia_init taxi r={SOFIA_WIDE_RANK}: the routes differ")
    if not all(1 <= g["graphs"] <= SOFIA_CAPTURES for g in graph) or any(e["graphs"] for e in eager):
        raise AssertionError(f"phase24 sofia_init taxi r={SOFIA_WIDE_RANK}: captures {[g['graphs'] for g in graph]}"
                             f" / {[e['graphs'] for e in eager]}")
    print(f"phase24 sofia_init taxi r={SOFIA_WIDE_RANK} ({SOFIA_WIDE_EPOCHS} epochs): graph route "
          f"({graph[0]['graphs']} captures a call) bitwise the route without graphs (factors, X, O, err_hist; 2 "
          f"runs each); graph {[round(g['ms'] / SOFIA_WIDE_EPOCHS, 3) for g in graph]} ms an epoch, eager "
          f"{[round(e['ms'] / SOFIA_WIDE_EPOCHS, 3) for e in eager]}; err_hist "
          f"{np.round(graph[0]['res'][3], 6).tolist()}", flush=True)

    # the stream at taxi, both routes; its scan timed apart
    frames = []
    scan = sofia._stream_scan

    def timed_scan(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = scan(*args)
        end.record()
        end.synchronize()
        frames.append((start.elapsed_time(end), args[0].shape[0]))
        return out

    x_np, _spec, _prov = load_dataset("taxi")
    mask_np = mask.cpu().numpy()
    sofia._stream_scan = timed_scan
    try:
        streams = [sofia._stream_device_run(x_np, mask_np, p.rank, m, 3, p.lambda1, p.lambda2, p.lambda3, 0.1, 0.05,
                                            p.max_epoch, 1e-3, True, torch.Generator().manual_seed(0),
                                            torch.float32, torch.device("cuda"), graphs)
                   for graphs in (True, False, False, True)]
    finally:
        sofia._stream_scan = scan
    if not all(_same_sofia(s_, streams[0]) for s_ in streams[1:]):
        raise AssertionError("phase24 sofia_stream_device taxi: the routes differ")
    w = streams[0][1]
    if not np.isfinite(w).all() or not np.isfinite(streams[0][2]).all():
        raise AssertionError("phase24 sofia_stream_device taxi: non-finite output")
    per = [ms / n for ms, n in frames]
    print(f"phase24 sofia_stream_device taxi (m={m}, {frames[0][1]} streamed frames after {3 * m} of batch init): "
          f"graph route bitwise the route without graphs (4 runs); ms a frame graph {per[0]:.4f}, {per[3]:.4f}, "
          f"eager {per[1]:.4f}, {per[2]:.4f} (events around the scan) ({CARD[0]})", flush=True)

    # float32 on the card against float64 on the CPU
    p32 = sofia._init_run(y, mask, p.rank, m, p.lambda1, p.lambda2, p.lambda3, x, SOFIA_EPOCHS["taxi"], p.tol, 300,
                          None, init, True)
    p64 = sofia._init_run(y.double().cpu(), mask.cpu(), p.rank, m, p.lambda1, p.lambda2, p.lambda3, x.double().cpu(),
                          SOFIA_EPOCHS["taxi"], p.tol, 300, None, init, False)
    np.testing.assert_allclose(p32[3], p64[3], rtol=SOFIA_INIT_RTOL)
    print(f"phase24 sofia_init taxi f32 card vs f64 CPU: err_hist max rel diff "
          f"{np.max(np.abs(p32[3] - p64[3]) / np.abs(p64[3])):.3e} over {len(p64[3])} epochs (rtol {SOFIA_INIT_RTOL})")
    _sofia_sweep_and_stream_against_the_cpu()
    return launches


def _sofia_sweep_and_stream_against_the_cpu() -> None:
    """The mode-3 step over taxi's 500 time rows and the stream over
    100x100 frames, float32 on the card against the same code in float64
    on the CPU."""
    from tritd_tpu_torch.baselines import sofia

    gen = torch.Generator().manual_seed(9)
    n3, r, m = 500, 3, 7
    half = torch.randn((n3, r, 4), generator=gen, dtype=torch.float64)
    args = (torch.randn((n3, r), generator=gen, dtype=torch.float64),
            torch.randn((n3, r), generator=gen, dtype=torch.float64), half @ half.transpose(1, 2))
    want = sofia._mode3_gauss_seidel(*args, 0.1, 0.001, m)
    got = sofia._mode3_gauss_seidel(*[a.float().cuda() for a in args], 0.1, 0.001, m)
    rtol, atol = SOFIA_SWEEP_TOL
    torch.testing.assert_close(got.cpu().double(), want, rtol=rtol, atol=atol)
    print(f"phase24 sofia mode-3 step (mode3_sweep) n3={n3} r={r} m={m}: f32 card vs f64 CPU within rtol {rtol}, "
          f"atol {atol}")

    n, frames = 100, 50
    u1, u2 = (torch.linalg.qr(torch.randn((n, r), generator=gen, dtype=torch.float64))[0] for _ in range(2))
    w = 5.0 + torch.rand((frames + m, r), generator=gen, dtype=torch.float64)
    y = torch.einsum("ir,jr,tr->tij", u1, u2, w[m:]) + 0.01 * torch.randn((frames, n, n), generator=gen,
                                                                           dtype=torch.float64)
    omega = (torch.rand((frames, n, n), generator=gen) > 0.1).double()
    state = (y, omega, u1, u2, w[:m], w[m - 1], torch.zeros(r, dtype=torch.float64),
             torch.zeros((m, r), dtype=torch.float64), torch.full((3, r), 0.1, dtype=torch.float64),
             torch.full((n, n), 0.1, dtype=torch.float64))
    rest = (m, 0.1, 0.001, 0.1, 0.05, True)
    want = sofia._stream_scan(*state, *rest, False)
    got = sofia._stream_scan(*[a.float().cuda() for a in state], *rest, True)
    scale = float(want[3].abs().max())
    for name, g, w_ in zip(("u1", "u2", "W", "X_hat", "O"), got, want):
        torch.testing.assert_close(g.cpu().double(), w_, rtol=SOFIA_STREAM_RTOL, atol=SOFIA_STREAM_RTOL * scale,
                                   msg=lambda s_, n_=name: f"{n_}: {s_}")
    print(f"phase24 sofia stream {n}x{n} r={r} m={m}, {frames} frames: f32 card (graph route) vs f64 CPU within rtol "
          f"{SOFIA_STREAM_RTOL}, atol {SOFIA_STREAM_RTOL} max|X|")


# --- phase 25: the Tensor Toolbox's loops on their device form --------------

TOOLBOX_LOOP_RANK = 10
TOOLBOX_LOOP_CP_SYM_RANK = 3
# iterations of each call (tol 0: every route and the CPU run as many)
TOOLBOX_LOOP_ITERS = {"cp_als": 25, "cp_als_sparse 10%": 10, "cp_als_sparse 90%": 10, "cp_nmu": 25, "cp_apr": 5,
                      "cp_arls": 25, "eig_sshopm": 100, "eig_sshopmc": 100, "eig_geap": 100, "gcp_opt": 100,
                      "cp_sym": 50, "tucker_hooi": 10}
# the routes of ops/toolbox_loop.py, in the order they run: the graph route
# (the default on the card) twice, around the other two
TOOLBOX_LOOP_TURNS = (("graphs", True), ("no graphs", False), ("host loop", None), ("graphs", True))
# cp_als_sparse's routes within this of each other (fit; reconstruction over
# its largest entry): index_add_ adds atomically, in any order
TOOLBOX_SPARSE_ROUTE_TOL = 1e-4
# each result held to the CPU float64 call: (key, relative?, tol), phase 15's
TOOLBOX_LOOP_HELD = {"cp_als": ("fit", False, 1e-4), "cp_als_sparse 10%": ("fit", False, 1e-4),
                     "cp_als_sparse 90%": ("fit", False, 1e-4), "cp_nmu": ("fit", False, 1e-4),
                     "cp_apr": ("log_likelihood", True, 1e-4), "cp_arls": ("fit", False, 1e-3),
                     "eig_sshopm": ("eigval", False, 1e-4), "eig_sshopmc": ("eigval", False, 1e-4),
                     "eig_geap": ("eigval", False, 1e-4), "gcp_opt": ("objective", True, 0.05),
                     "cp_sym": ("loss", True, 0.05), "tucker_hooi": ("fit", False, 1e-4)}


def _toolbox_loop_inputs() -> dict:
    """The numpy float64 inputs of phase 25 at phase 15's sizes: taxi (and
    its nonnegative counts, its COO at 10% and 90%), a 40^4 symmetric tensor
    with three rank-one terms and teneye(4, 40), TOOLBOX_OPT_SHAPE counts."""
    from tritd_tpu_torch import ops

    x_np, _spec, _prov = load_dataset("taxi")
    x_np = np.ascontiguousarray(x_np, dtype=np.float64)
    rng = np.random.default_rng(25)
    out = {"x": x_np, "shape": x_np.shape, "counts": np.round(np.abs(x_np)),
           "init": [rng.random((s, TOOLBOX_LOOP_RANK)) for s in x_np.shape]}
    for keep in (0.10, 0.90):
        out[f"coo {keep:.0%}"] = _coo(x_np, keep, seed=int(keep * 100))
    n = TOOLBOX_SYM_N
    noise = rng.standard_normal((n,) * 4)
    sym = sum(noise.transpose(p) for p in itertools.permutations(range(4))) / 24.0
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    out["a"] = 0.02 * sym + sum(w * np.einsum("i,j,k,l->ijkl", c, c, c, c) for w, c in zip((5.0, 3.0, 2.0), u.T))
    out["eye"] = ops.teneye(4, n, dtype=torch.float64, device="cpu").numpy()
    out["x0"] = rng.standard_normal(n)
    out["x0c"] = out["x0"] + 0.01j * rng.standard_normal(n)
    out["sym_init"] = (rng.standard_normal(TOOLBOX_LOOP_CP_SYM_RANK),
                       rng.standard_normal((n, TOOLBOX_LOOP_CP_SYM_RANK)) / np.sqrt(n))
    shape = TOOLBOX_OPT_SHAPE
    truth = [rng.random((s, 5)) + 0.1 for s in shape]
    out["opt_counts"] = np.round(5.0 * np.einsum("ir,jr,kr->ijk", *truth))
    out["opt_init"] = [0.5 * rng.random((s, 5)) + 0.01 for s in shape]
    return out


def _toolbox_loop_call(name: str, d: dict, max_iters: int) -> dict:
    """One phase-25 call on the tensors `d` (`_toolbox_loop_inputs()` on a
    device), at tol 0."""
    from tritd_tpu_torch import ops

    r = TOOLBOX_LOOP_RANK
    if name == "cp_als":
        return ops.cp_als(d["x"], r, max_iters=max_iters, tol=0.0, init_factors=d["init"])
    if name.startswith("cp_als_sparse"):
        vals, coords = d["coo " + name.split()[-1]]
        return ops.cp_als_sparse(vals, coords, d["shape"], r, max_iters=max_iters, tol=0.0, init_factors=d["init"])
    if name == "cp_nmu":
        return ops.cp_nmu(d["counts"], r, max_iters=max_iters, tol=0.0, init_factors=d["init"])
    if name == "cp_apr":
        return ops.cp_apr(d["counts"], r, max_outer=max_iters, tol=0.0, init_factors=d["init"])
    if name == "cp_arls":
        return ops.cp_arls(d["x"], r, max_iters=max_iters, tol=0.0, generator=torch.Generator().manual_seed(25),
                           init_factors=d["init"])
    if name == "eig_sshopm":
        return ops.eig_sshopm(d["a"], shift=1.0, max_iters=max_iters, tol=0.0, x0=d["x0"])
    if name == "eig_sshopmc":
        return ops.eig_sshopmc(d["a"], shift=2.0, max_iters=max_iters, tol=0.0, x0=d["x0c"])
    if name == "eig_geap":
        return ops.eig_geap(d["a"], d["eye"], shift=1.0, max_iters=max_iters, tol=0.0, x0=d["x0"])
    if name == "gcp_opt":
        return ops.gcp_opt(d["opt_counts"], 5, loss="count", max_iters=max_iters, tol=0.0,
                           init_factors=d["opt_init"])
    if name == "cp_sym":
        res = ops.cp_sym(d["a"], TOOLBOX_LOOP_CP_SYM_RANK, max_iters=max_iters, tol=0.0, init=d["sym_init"])
        return {**res, "loss": (1.0 - res["fit"]) ** 2}
    if name == "tucker_hooi":
        return ops.tucker_hooi(d["x"], (5, 5, 5), max_iters=max_iters, tol=0.0)
    raise KeyError(name)


def _toolbox_loop_cpu(name: str, arrays: dict, max_iters: int) -> tuple[dict, float]:
    """In a worker of `_cpu_pool()`: the 0-d results of the phase-25 call
    `name` in float64 on the CPU (its host loop), and its seconds."""
    torch.set_num_threads(CPU_REF_THREADS)
    t0 = time.perf_counter()
    res = _toolbox_loop_call(name, {k: _to(v, "cpu", torch.float64) for k, v in arrays.items()}, max_iters)
    return ({k: v.item() for k, v in res.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
            | {"n_iters": res["n_iters"]}), time.perf_counter() - t0


def _toolbox_loop_arrays(name: str, inputs: dict) -> dict:
    keys = {"cp_als": ("x", "init"), "cp_als_sparse 10%": ("coo 10%", "shape", "init"),
            "cp_als_sparse 90%": ("coo 90%", "shape", "init"), "cp_nmu": ("counts", "init"), "cp_apr": ("counts", "init"),
            "cp_arls": ("x", "init"), "eig_sshopm": ("a", "x0"), "eig_sshopmc": ("a", "x0c"),
            "eig_geap": ("a", "eye", "x0"), "gcp_opt": ("opt_counts", "opt_init"), "cp_sym": ("a", "sym_init"),
            "tucker_hooi": ("x",)}
    return {k: inputs[k] for k in keys[name]}


def phase25_cpu_references(inputs: dict | None = None) -> dict:
    """Submits phase 25's CPU float64 calls to the pool: name -> future."""
    inputs = _toolbox_loop_inputs() if inputs is None else inputs
    return {name: _cpu_pool().submit(_toolbox_loop_cpu, name, _toolbox_loop_arrays(name, inputs), iters)
            for name, iters in TOOLBOX_LOOP_ITERS.items()}


def _toolbox_routes_differ(name: str, got: dict, want: dict) -> str:
    """'' when two routes' results agree: bitwise, cp_als_sparse within
    TOOLBOX_SPARSE_ROUTE_TOL; else what differs."""
    from tritd_tpu_torch import ops

    if got["n_iters"] != want["n_iters"]:
        return f"n_iters {got['n_iters']} / {want['n_iters']}"
    if not name.startswith("cp_als_sparse"):
        g, w = dict(_named_tensors(got)), dict(_named_tensors(want))
        return ", ".join(k for k in w if not _same_bits(g[k], w[k]))
    fit = abs(float(got["fit"]) - float(want["fit"]))
    full_g, full_w = (ops.ktensor_full(r["factors"], r["weights"]).double() for r in (got, want))
    rec = float((full_g - full_w).abs().max() / full_w.abs().max())
    bad = fit > TOOLBOX_SPARSE_ROUTE_TOL or rec > TOOLBOX_SPARSE_ROUTE_TOL
    return f"|fit diff| {fit:.2e}, reconstruction {rec:.2e}" if bad else ""


def _named_tensors(res: dict):
    for key, value in res.items():
        if isinstance(value, torch.Tensor):
            yield key, value
        elif isinstance(value, (list, tuple)):
            yield from ((f"{key}.{i}", v) for i, v in enumerate(value))


def phase25(refs: dict | None = None) -> list:
    """The Tensor Toolbox's ten loops (ops/toolbox_loop.py) at phase 15's
    sizes in float32, each on the graph route (the default), the device
    form without graphs and the host loop, in turns graph, no graphs, host
    loop, graph: bitwise (cp_als_sparse within TOOLBOX_SPARSE_ROUTE_TOL),
    captures (one a graph-route call, none on the others), synchronizing
    calls, ms an iteration (events), the graph route's time to its first
    replay and its replays' ms an iteration, peak MiB above the call's
    start; each held to the same call in float64 on the CPU (its host loop, in the pool's worker
    processes). Returns the rows for PERF.md."""
    from tritd_tpu_torch.ops import toolbox_loop

    inputs = _toolbox_loop_inputs()
    if refs is None:
        refs = phase25_cpu_references(inputs)
    rows = []
    for name, iters in TOOLBOX_LOOP_ITERS.items():
        _release_cached()
        card = {k: _to(v, "cuda", torch.float32) for k, v in _toolbox_loop_arrays(name, inputs).items()}
        for _label, graphs in TOOLBOX_LOOP_TURNS[:3]:  # the libraries' set-up out of the times
            with toolbox_loop.forced_route(graphs):
                _toolbox_loop_call(name, card, 2)
        runs: dict = {}
        hopper_kernels.reset_launch_counts()
        for label, graphs in TOOLBOX_LOOP_TURNS:
            with toolbox_loop.forced_route(graphs):
                runs.setdefault(label, []).append(_watched(lambda: _toolbox_loop_call(name, card, iters)))
        calls = _linalg_calls()  # the binding's, on every route (tucker_hooi's eigh)
        if name == "tucker_hooi" and not calls:
            raise AssertionError("phase25 tucker_hooi: no call of ops/device_linalg.py's drivers")
        graph = runs["graphs"]
        res = graph[0]["res"]
        n = res["n_iters"]
        differ = {f"{a} vs {b}": _toolbox_routes_differ(name, runs[a][i]["res"], runs[b][j]["res"])
                  for a, i, b, j in (("graphs", 0, "no graphs", 0), ("graphs", 1, "graphs", 0),
                                     ("host loop", 0, "no graphs", 0))}
        want_syncs = (n + 1 if n < iters else n) + (name == "cp_arls")
        captures = {label: [r["graphs"] for r in rs] for label, rs in runs.items()}
        syncs = {label: [r["syncs"] for r in rs] for label, rs in runs.items()}
        if (any(differ.values()) or n != iters or captures != {"graphs": [1, 1], "no graphs": [0], "host loop": [0]}
                or any(k != want_syncs for k in syncs["graphs"])):
            raise AssertionError(f"phase25 {name}: routes differ {differ}; n_iters {n} (want {iters}); captures "
                                 f"{captures}; synchronizing calls {syncs} (graph route: want {want_syncs})")
        if not all(bool(torch.isfinite(t).all()) for _k, t in _named_tensors(res)):
            raise AssertionError(f"phase25 {name}: not finite")
        want, cpu_s = refs[name].result()
        key, relative, tol = TOOLBOX_LOOP_HELD[name]
        dist = abs(complex(res[key]) - complex(want[key])) / (abs(complex(want[key])) if relative else 1.0)
        if not (dist <= tol and want["n_iters"] == n):
            raise AssertionError(f"phase25 {name}: {key} {complex(res[key])} on the card, {complex(want[key])} on the "
                                 f"CPU in f64 ({'rel' if relative else 'abs'} diff {dist:.3e}, tol {tol:g}); n_iters "
                                 f"{n} / {want['n_iters']}")
        ms = {label: [r["ms"] / n for r in rs] for label, rs in runs.items()}
        first = [r["before_replays_ms"] for r in graph]
        replays = [r["replays_ms"] / (n - 1) for r in graph]
        peak = {label: rs[0]["call_peak_mib"] for label, rs in runs.items()}
        sparse = f"within {TOOLBOX_SPARSE_ROUTE_TOL:g}" if name.startswith("cp_als_sparse") else "bitwise"
        value = complex(res[key])
        print(f"phase25 {name} ({n} iterations, tol 0): ms/iter graph route {ms['graphs'][0]:.4f} / "
              f"{ms['graphs'][1]:.4f} (events; {first[0]:.2f} / {first[1]:.2f} ms to the first replay, "
              f"{graph[0]['capture_host_ms']:.2f} ms of capture host time, then {replays[0]:.4f} / {replays[1]:.4f} "
              f"ms/iter), no graphs {ms['no graphs'][0]:.4f}, host loop {ms['host loop'][0]:.4f}; captures "
              f"{captures}; synchronizing calls {syncs} (graph route want {want_syncs}); peak MiB above the "
              f"call's start {', '.join(f'{k} {v:.1f}' for k, v in peak.items())} (all allocated: "
              f"{graph[0]['peak_mib']:.1f}); routes {sparse} (graph vs no graphs, graph vs "
              f"graph, host loop vs no graphs); {key} {value if value.imag else value.real} vs CPU f64 "
              f"{'rel' if relative else 'abs'} diff {dist:.3e} (tol {tol:g}, CPU {cpu_s:.1f} s)"
              + (f"; binding calls over the four runs {calls}" if calls else "") + f"; {CARD[0]}", flush=True)
        rows.append({"name": name, "iters": n, "ms": ms, "first_replay_ms": first, "replay_ms": replays,
                     "syncs": syncs, "peak_mib": peak, "dist": dist})
        runs = graph = res = card = None
    return rows


def _source_of() -> dict:
    """Variant -> the .cu file of the repo that holds its entry point."""
    where = {}
    for src in build.sources():
        for variant in re.findall(r"^TRITD_BLOCK_ENTRY\(tritd_elementwise_block_(\w+),", src.read_text(), re.M):
            where[variant] = src.relative_to(HERE).as_posix()
    return where


def _timed(n, phase):
    t0 = time.perf_counter()
    out = phase()
    print(f"phase{n} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    try:
        _main()
    finally:
        for pool in _CPU_POOL:
            pool.shutdown(cancel_futures=True)


def _main() -> None:
    device = phase0()
    phase1()
    records = _timed(2, phase2)
    launches, phase3_checks = _timed(3, phase3)
    toolbox_refs = phase25_cpu_references()  # after phase 3's in the pool's queue
    _timed(4, phase4)
    for variant, count in _timed(5, phase5).items():
        launches[variant] = launches.get(variant, 0) + count
    for n, phase in ((6, phase6), (7, phase7), (8, phase8)):
        _timed(n, phase)
    records9, jacobi_launches, jacobi_check = _timed(9, phase9)
    for key, n in _timed(10, phase10).items():
        jacobi_launches[key] = jacobi_launches.get(key, 0) + n
    video_launches, video_check = _timed(26, phase26)
    for key, n in video_launches.items():
        jacobi_launches[key] = jacobi_launches.get(key, 0) + n
    _timed(11, phase11)
    for variant, count in _timed(12, phase12).items():
        launches[variant] = launches.get(variant, 0) + count
    for n, phase in ((13, phase13), (14, phase14), (15, phase15), (16, phase16)):
        _timed(n, phase)
    for variant, count in _timed(17, phase17).items():
        launches[variant] = launches.get(variant, 0) + count
    phase18()
    for variant, count in _timed(19, phase19).items():
        launches[variant] = launches.get(variant, 0) + count
    _timed(20, phase20)
    _timed(21, phase21)
    batch_launches = _timed(22, phase22)
    _timed(23, phase23)
    sofia_launches = _timed(24, phase24)
    _timed(25, lambda: phase25(toolbox_refs))
    # phase 3's CPU references ran in worker processes through phases 4-25
    _timed("3 checks", phase3_checks)
    _timed("9 checks", jacobi_check)
    _timed("26 checks", video_check)
    variants = set(hopper_kernels.KERNEL_VARIANTS.values())
    if set(jacobi_launches) != set(hopper_kernels.JACOBI_SVD_LAUNCHES) or not all(jacobi_launches.values()):
        raise AssertionError(f"the Jacobi SVD's launches on the main path (phases 9, 10, 26): {jacobi_launches}")
    missing = sorted(variants - {v for v, n in launches.items() if n})
    if missing or set(records) != variants:
        raise AssertionError(f"kernel variants not launched by the main path: {missing}; "
                             f"not timed in phase 2: {sorted(variants - set(records))}")
    sources = _source_of()
    print(json.dumps({"kernels": [{
        "name": "elementwise_block",
        "variant": variant,
        "route": "cuda",
        "source": sources[variant],
        "replaces": "tritd_tpu/ops/pallas_kernels.py:133",
        "launches": launches[variant],
        "pointer_launches": POINTER_ON_MAIN_PATH.get(variant, 0),
        "batch_launches": batch_launches.get(variant, 0),
        **record,
    } for variant, record in records.items()] + [{
        "name": name,
        "variant": tag,
        "route": "cuda",
        "source": "tritd_tpu_torch/csrc/sofia_kernels.cu",
        "replaces": SOFIA_REPLACES[name],
        "launches": sofia_launches[name, tag],
        **record,
    } for (name, tag), record in records9.items() if name in SOFIA_REPLACES] + [{
        "name": name,
        "variant": tag,
        "route": "cuda",
        "source": "tritd_tpu_torch/csrc/jacobi_svd.cu",
        "replaces": JACOBI_REPLACES,
        "launches": jacobi_launches.get(f"{name}[{tag}]", 0),
        **record,
    } for (name, tag), record in records9.items() if name == "jacobi_svd"]}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
