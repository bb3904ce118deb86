#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one GPU and check them.

The 2D path is the solve bench.py times for the JAX package: the 2D Poisson
problem u = sin(pi x) sin(pi y) on a 1025^2 grid, an fp32 level hierarchy
smoothed by red-black Gauss-Seidel V(2,2) cycles, and mixed-precision
iterative refinement (fp64 outer residual, two fp32 cycles per outer step)
from a full-multigrid start, to 1e-9 relative residual. The 3D path is
solve_poisson3d(precision='fp32') on u = sin(pi x) sin(pi y) sin(pi z) at
513^3: the same refinement around fp32 RB-GS V(2,2) cycles on nine levels,
from a zero start, to 1e-9 relative residual. The variable-coefficient and
Robin path is solve_poisson(precision='fp32') at 1025^2 on three problems:
-div(a grad u) = f with a = 1 + x + y, a 1000:1 coefficient jump at x = 0.5,
and Poisson with a Robin east side; the same refinement, from a zero start.

Phases, each of which must pass:
  1. print the card (nvidia-smi name and power limit) and the host's tools;
  2. build the CUDA kernels from csrc/ with nvcc and print the build time;
  3. hold each 2D kernel (A-D) against its plain PyTorch twin on the card at
     the 2D path's shapes, and time both with CUDA events; hold D from
     129^2 against the same V-cycle run through A, B and C launches (the
     tail gate shut) and report whether they agree bit for bit;
  4. solve the 2D path with backend='auto' (the kernels), from launch
     counts reset to zero, and check the iteration count, the error against
     the exact solution, that every kernel launched, and that A and D made
     exactly their planned launches (48 and 16 in the 3-step solve);
  5. solve it again with backend='torch' (the plain path on the card) and
     check that both paths agree;
  6. time both 2D paths over 16 frequency-swept right-hand sides as bench.py
     does, and print per-solve ms and DoF/s; profile one kernel-path solve
     (device ops and busy share); read with torch.profiler A's and L's
     device time per 2-sweep call at 1025^2, 513^2 and 257^2, B's and C's
     per call at 1025^2, and D's per launch on the main tail from entries
     3^2 to 129^2;
  7. hold each 3D kernel (E-G) against its twin at 513^3, 257^3, 129^3 and
     5^3, bit for bit (E also reversed, with omega != 1, with 3 sweeps at
     257^3, and with the coarsest solve's 32 sweeps at 5^3 and 3^3), time
     both, read the device time per launch from torch.profiler (E at
     513^3, F and G at 513^3 and 257^3), and time G against the in-place
     yardstick u.mul_(2.0) at 513^3 in turns; then hold N's step and start
     at 513^3 on card tensors, fp32 and bf16 level storage, against its
     twin (u_out and r_lo bit for bit, the norms to 1e-13), and time N's
     step and the twin's (CUDA events) and N's device time per launch;
  8. solve the 3D path at 257^3 and at 513^3 with backend='auto', the
     513^3 run from launch counts reset to zero, and check convergence, the
     outer-step count of the JAX reference, the l2 error against the closed
     form, that E made exactly the launches it plans for the solve's
     smoothing calls (one per call, 170), F and G one per transfer call
     (80 each) and N one at the start and one per outer step (6); print
     the peak device memory;
  9. solve it at 513^3 with backend='torch' and check that both paths agree;
 10. time both 3D paths over frequency-swept right-hand sides, print ms and
     DoF/s, and profile one kernel-path solve with torch.profiler;
 11. hold each coefficient-plane kernel against its twin at the path's
     shapes (H at 1025^2, 513^2, 257^2 on both coefficient fields; I from
     1025^2, 513^2, 257^2 on three side sets; C with the Robin sides; J
     from 129^2 on both fields), time both, and read J's device time per
     launch from 129^2 on both fields;
 12. solve the three problems with backend='auto', each from launch counts
     reset to zero, and check the outer-step count and the l2 error of the
     JAX reference, which kernels launched, and on the varcoef and jump
     solves that H made its planned launches (one per 2-sweep call: 180 in
     the 15-step jump solve) and J one per cycle;
 13. solve them with backend='torch' and check that both paths agree;
 14. time both paths per solve, and profile the jump solve;
     then H's device time per 2-sweep call (every device op of the call,
     the copy-back included) and launches per call at 1025^2, 513^2 and
     257^2, J's device time per launch from entries 3^2 to 129^2 on the
     jump tail, and I's device time per call at 1025^2.
The parity paths (after phase 5): the parity-plane solve plane_ir_solve at
1025^2 (level 0 held as four parity planes, smoothed by kernel K; levels
>= 1 on kernels A-D) and the main path with the parity layout of kernel A
(kernel L) switched on; and the microbenchmark probes (kernel M):
 15. hold K (1025^2 and 513^2 planes, 2 sweeps, omega 1 and 1.3; 5 sweeps,
     two launches, at 513^2; 3 sweeps on the odd-sided (1000, 771) field's
     planes, padding included), L (1025^2, 513^2, 257^2; 1, 2, 3 sweeps and
     omega 1.3; 5 sweeps at 513^2; (1000, 771)) and the probes, the copy
     and the c = 4 parity probe (513^2, 1025^2) against their twins, bit for
     bit, and L against A; read K's device time and launches per 2-sweep
     call at 1025^2 and 513^2 planes (one launch each) and the probe's
     device time per 2-sweep call (one launch) in every mode at 513^2 and
     1025^2 with its share of the call's bound, and roll - none;
     time A, K and L per 2-sweep call at 1025^2 in turns; the copy (also
     exact at 8192^2) against torch.mul in turns at 1025^2 and 8192^2,
     bandwidth and device time per launch (torch.profiler) in every turn;
 16. solve the 1025^2 main path (FMG, IR) with PARITY_DEFAULT on, from
     launch counts reset to zero: L makes exactly its planned launches (48,
     one per 2-sweep call, as A on the direct path) and A's RB-GS none, 3
     outer steps, u equal to the direct layout's bit for bit; time it and
     profile one solve (device ops per solve);
 17. run the microbenchmark (benchmarking/kernel_microbench.run at 513^2 and
     1025^2) from launch counts reset to zero: the probe and copy launch,
     the probe once per call; its us per call in every mode beside the
     call's bound;
 18. solve plane_ir_solve at 1025^2 with backend='auto', from launch counts
     reset to zero: the JAX reference's 4 outer steps, l2 within 2% of
     3.92e-7, K made exactly its planned launches (16: one per 2-sweep
     call) and A-D launched on levels >= 1; then with
     backend='torch' and against the standard ir_solve(use_fmg=False) on the
     same levels: the same count and u within 1e-8;
 19. time the plane solve against the standard no-FMG solve, in turns, and
     profile one plane solve.
The rest of the 2D operator (after phase 10), at 1025^2 through
solve_poisson(precision='fp32', tol 1e-9), each solve from launch counts
reset to zero, each checked against the JAX reference's outer-step count
and l2 error and against the same solve with backend='torch':
 20. W and F cycles on the Poisson problem: first A at 129^2 and 65^2, B
     and C between 129^2 and 65^2 and D from 65^2 (the entries the W and F
     branches give them) against their twins, and, for phase 22, A on the
     coarsest level (32 sweeps) of the anisotropic and the isotropic
     hierarchy and B and C between 1025^2 and 513^2 with the anisotropic
     stencil; then A, B, C and D make
     exactly the launches their plan derives from the recursion (W: D
     from 65^2 only; F: from 65^2 and 129^2);
 21. periodic and segmented sides (periodic_helmholtz_mms,
     mixed_segment_problem, mixed_segment_mms): no 2D kernel launches, and
     the periodic duplicate nodes equal node 0;
 22. line_y and ADI smoothing on the anisotropic problem, Chebyshev on the
     Poisson problem: B and C on every transfer, A on every coarsest
     solve, D never;
     then ms per solve (minimum of 3, the checked solves the warm-up) of
     each, the plain path's too for Chebyshev, and profiles of the W,
     line_y and periodic solves.
Precision staging and irregular domains (after phase 22), at 1025^2 on
poisson_mms_sinsin, tol 1e-9, RB-GS omega 1, each solve from launch counts
reset to zero and held to the JAX reference's count and l2 error:
 23. A (1025^2, 513^2, 257^2 and the coarsest 3^2 with 32 sweeps), B (bf16
     and fp32 into bf16) and C between 1025^2 and 513^2, and D from 129^2
     on an all-bf16 and on a mixed tail, on bf16 data from the seed,
     against their twins bit for bit, with device ms per call on bf16
     beside fp32; A on a bf16 u over an fp32 f and an fp32 u over a bf16 f
     (1025^2, 257^2, (9, 61); RB-GS, reversed, Jacobi, SOR; 1-5 sweeps)
     against its twin bit for bit; solve_poisson(precision='mixed') on both backends (5 +- 1
     steps on the plain path, 5 +- 2 on the kernels, where A-C run only on
     the fp32 levels above the tail and D once per V-cycle),
     precision='adaptive' (15 +- 2, one switch to 'ir'),
     refinement.adaptive_solve(start=BF16) on both backends (16 +- 3 on the
     plain path, switches (5, 'fp32') then 'ir', A-D launched on bf16
     storage on the kernel path), autotune over fp32, mixed and adaptive
     (runs=1) and precision='auto' taking its cached choice; ms per solve and
     profiles of the mixed and bf16-start solves;
 24. corner_singularity_problem (3 +- 1 steps, A-D as planned) and
     l_shaped_problem (5 +- 1, no 2D kernel launch) on both backends, their
     ms per solve and profiles, and every CATALOGUE problem built at 65^2.
Galerkin coarsening and the Krylov solvers (after phase 24), each run from
launch counts reset to zero and held to the JAX reference's count:
 25. solve_poisson(precision='fp32', tol 1e-9, coarsening='galerkin') on
     the jump (5 steps, final relative residual below 1e-9) and Poisson (4,
     l2 within 2% of 3.92183e-7) problems at 1025^2 on both backends: level
     0 alone takes a kernel (H on the jump problem, A on Poisson, one
     launch per 2-sweep call), the Stencil9 levels none; 'auto' = 'torch'
     within 1e-8 relative; the fp64 RAP chain built on the card equals the
     CPU's within 1e-12; set-up ms, ms per solve and a profile of each;
 26. the Krylov solvers: pcg, fcg and gmres(restart=30) with the multigrid
     preconditioner (symmetric V-cycles over fp32 levels, fp64 vectors) on
     the exponential problem at 1025^2 (7, 7, 30 iterations at tol 1e-10,
     1e-10 and 1e-9; A, B, C, D
     4, 2, 2, 1 launches per application, level 0 plain fp64; pcg 'auto' =
     'torch'), pcg over a Galerkin hierarchy on the jump problem (8, no
     kernel), bicgstab with the diagonal and pcg with the Chebyshev and the
     line preconditioners at 257^2 (500, 231, 500: plain torch), and pcg
     with the 3D multigrid preconditioner at 257^3 (8; E, F and G on every
     level below level 0); ms per solve and profiles of the three
     multigrid-preconditioned solves.
The heat equations (after phase 26; HEAT_RUNS, HEAT3D_RUNS), every
implicit step a shifted-operator V-cycle (c + lam on every level):
 27. first A, B, C and D on the shifted hierarchy of a 1025^2 CN step (lam
     = 1/(0.5 dt) in fp32), H, I, C and J on the shifted levels of the
     a = 1 + x + y problem, I and C on those of neumann_heat, and E, F and
     G on a shifted 513^3 level against their twins (H-J, C with sides and
     E-G bit for bit; A-D reported); then solve_heat at 1025^2 with the
     default HeatConfig: pure diffusion by CN (10 steps, dt 1e-4), BDF2
     (10, its CN bootstrap included), backward Euler (5) and explicit Euler
     (10 at 0.9 x the stability limit), all fp32; CN on neumann_heat and
     on the a = 1 + x + y problem (5 each, fp32); CN in fp64 (10 steps, dt
     2e-3) and adaptive CN in fp64 on pure_diffusion(257) (t_final 0.05,
     dt0 0.005, dt_tol 1e-5). Each run from launch counts reset to zero:
     launches equal to the plan per V-cycle times the cycles counted (A,
     B, C three times and D once per cycle, 12 cycles per fp32 step; H, I,
     C, J; I and C on every level), none on fp64 or explicit runs; fp64
     runs at the JAX reference's steps and l2 (HEAT_REF, +-2%), fp32 runs
     under HEAT_L2_BOUND and equal to backend='torch' on the card (bit for
     bit without A-D, else within HEAT_PATH_RTOL); a 5 + 5 step checkpoint
     resume equal to the uninterrupted CN run bit for bit; ms per step
     (minimum of 3) and a profile of one CN step;
 28. solve_heat3d on oscillating3d in fp32 (cycles_per_step 2): CN at 513^3
     and 257^3 and BDF2 at 257^3, 10 steps of dt 1e-3 each (the 513^3 CN
     run also in fp64 and with 8 cycles, l2 printed): E, F and G make their
     planned launches per cycle (2 cycles per step), l2 under
     HEAT3D_L2_BOUND, backend='torch' on the card equal bit for bit, peak
     memory, ms per step (minimum of 2) and a profile of a one-step 513^3
     run.
The rest of 3D (after phase 28): bf16 storage in E, F and G, the 3D
precisions and the 3D operator, each run from launch counts reset to zero:
 29. E (the bf16 levels of the 513^3 'bf16' and 'mixed' hierarchies: 513^3
     with both colour orders and omega 1.3, 257^3 with 3 sweeps, an fp32
     pass then a bf16 one, 33^3 to 5^3, and the coarsest 3^3 with 32
     sweeps), F and G (513 <-> 257 all bf16, the mixed crossing 65 <-> 33
     with an fp32 fine level and a bf16 coarse one, 33 <-> 17 all bf16)
     against their twins bit for bit; the bf16 copies' alignment cases:
     E at (37, 66, 70) (nz even), (33, 34, 131) (nz odd) and
     513^3, u and f views at odd storage offsets, 2 sweeps and 5 (the
     multi-launch storages), an fp32 u with a bf16 f; F at (37, 69, 131)
     and 513 -> 257 with views at odd offsets and both crossings, bit for
     bit; CUDA-event ms of kernel and twin at 513^3 and device ms per
     launch on bf16 beside fp32 with the 2-byte bound;
 30. solve_poisson3d(precision='mixed') at 513^3: the twins' outer-step
     count (MIXED3D_TWINS), l2 within 2% of 1.1093e-6, E, F and G launches
     (all, and bf16 apart) equal to the plan of the mixed levels, N one at
     the start and one per outer step, ms per
     solve, peak memory and a profile; precision='bf16' at 513^3 for
     BF16_3D_ITERS cycles: every level on E-G in bf16 as planned, the same
     solve with every kernel call replaced by its twin on the card equal
     bit for bit, the l2 at most the plain path's (bf16 after every op);
     precision='adaptive' at 257^3: the JAX package's iterations, switch
     to 'ir' and l2;
 31. the 3D operator, each solve held to the JAX package's count and l2
     (OPERATOR3D_REF): jump_coefficient3d at 513^3 and, at 257^3,
     neumann3d_test, periodic3d_helmholtz (duplicate nodes equal to node
     0), anisotropic3d_z with line_z (F and G on every transfer, E on the
     coarsest solve), a W-cycle Poisson solve (E-G per the recursion's
     plan), coarsening='galerkin' on jump_coefficient3d, and solve_heat3d
     CN in fp64 with a = 1 + x + y + z (5 steps); no E-G launch on a
     coefficient, Neumann, periodic or Stencil27 level; convergence_study3d
     at 33^3 and 65^3 (observed l2 order 2).
bf16 storage in H, I, J and L, the 2D variable-coefficient precisions and
explicit distribution (after phase 31):
 32. H (the bf16 jump levels 1025^2, 513^2, 257^2: RB-GS, reversed,
     Jacobi, 5 SOR sweeps; 32 sweeps at 17^2), I (bf16 into bf16 and fp32,
     the mixed hierarchy's fp32 -> bf16 crossing, Robin sides, with C), J
     (from 129^2 on a bf16 tail and on the mixed tail, an fp32 entry over
     bf16 levels) and L (1025^2, 513^2, 257^2; 1, 2, 3, 5 sweeps; equal to
     A) against their twins bit for bit; H and L on both mixed u/f storages
     (1025^2, 257^2, (9, 61); 1-5 sweeps) bit for bit; CUDA-event ms of
     kernel and twin,
     device ms per call on bf16 beside fp32;
 33. solve_poisson(precision='mixed' | 'bf16') and adaptive_solve(start=
     BF16) on the varcoef, jump and Robin problems at 1025^2, each from
     launch counts reset to zero: the kernel path at its CPU twins' count
     and l2 (VAR_PRECISION_TWINS), equal bit for bit to the same solve with
     every kernel call replaced by its twin on the card, H, I, C and J
     launches (all, and bf16 apart) equal to the plan (the mixed jump
     solve: J from 129^2 on an fp32 entry); the plain path at the JAX
     package's count, switches and l2 (VAR_PRECISION_REF); the 1025^2
     Poisson 'bf16' solve with the parity layout (L, B, C, D on bf16 per
     plan, equal to its twin path); ms per solve (fp32 beside) and two
     profiles;
 34. halo_solve over NCCL, one spawned rank per visible card, on the mesh of
     the whole world: poisson_mms_sinsin(1025) and
     jump_coefficient_problem(1025) in fp64 held to mg_solve (iterations,
     HALO_ATOL), shard_smooth, global_residual_norm and make_sharded_field
     on that mesh; prints the world size, the mesh and the sharded depth S.
     On one card the world is one rank and S = 0, so halo_solve is mg_solve
     and the phase checks only the plumbing; halos cross cards on a host of
     several (scripts/halo_cards.py runs this phase alone);
 35. the GSPMD path over NCCL, one spawned rank per visible card, on the
     mesh of the whole world: solve_poisson(poisson_mms_sinsin(1025),
     mesh=) in 'fp64', 'mixed' and 'adaptive', sharded_solve with ADI on
     poisson_mms_anisotropic(1025, ay=0.01) and on the Galerkin
     jump_coefficient_problem(1025), and MG-preconditioned CG on
     shard_inputs vectors with a make_constrainer preconditioner, on
     backend 'auto' (kernel A smooths the fp32 and bf16 levels, on the
     split levels' haloed windows), each held on every rank to the same
     call on a one-rank mesh, the single-device solve under the hook
     (iterations, SHARDED_ATOL, and equal A and H launches, which 'mixed'
     and 'adaptive' must have), beside the single-device plain solve;
     prints the sharded depth and tiers, the iterations, the largest
     differences, the launches, rank 0's first call and the plain and
     kernel paths' seconds. On one card the world is one rank and no level
     is split, so the phase checks only the plumbing;
     scripts/sharded_cards.py runs it alone, on four cards with the graded
     mesh too;
 36. the 3D hook and sharded time stepping over NCCL, one spawned rank per
     visible card, on the mesh of the whole world, backend 'auto':
     solve_poisson3d(poisson3d_mms_sinsinsin, mesh=) in 'mixed' at 513^3
     and 'adaptive' at 257^3 (make_constrainer3d: (x, y) blocks of whole
     z-lines, kernel E on the split levels' haloed windows and the
     replicated levels whole, F and G off), solve_heat(pure_diffusion(1025),
     mesh=) fp32 CN for 5 steps and solve_heat3d(pure_diffusion3d(257),
     mesh=) fp32 CN for 3 steps (the time loop on blocks, one global
     gather at its end), each held on every rank to the same call on a
     one-rank mesh (counts, the solution bit for bit, equal launches of E
     or A, at least one) and to the unhooked single-device kernel path
     (counts, PATH3D_ATOL, the fp32 heat states SHARDED_HEAT_ATOL; the
     513^3 l2 within L2_RTOL of its expected value); prints ms per solve
     or step beside the one-rank and kernel paths' and each rank's busy
     share. On one card the world is one rank and no level is
     split, so the phase checks only the plumbing; scripts/sharded_cards.py
     36 runs it alone.
The support layers (after phase 36), on backend 'auto', each run from
launch counts reset to zero; the phase uses neither matplotlib nor pyyaml:
 37. MMSValidator(precision='mixed', tol 1e-9) on poisson_mms_sinsin at
     129^2-1025^2 (L2 order within 2 +- 0.3; A, B, C and D launched; the
     1025^2 row's outer steps equal to the same solve_poisson call's) and
     in fp32 on poisson3d_mms_sinsinsin at 65^3-257^3 (E, F and G
     launched); measure_two_grid_factor on the 1025^2 fp32 hierarchy on
     'auto' (A launched) and 'torch' (rho below 0.15 on both, within 0.01
     of each other); validate_h_independence at 257^2-1025^2 in fp32;
     BenchmarkSuite at 257^2-1025^2 in fp32, fp64 and 'mixed' on both
     backends (runs=3; every record converged; records, speedups and the
     fp32 scaling exponent printed, the 1025^2 'mixed' time beside phase
     6's); PerformanceBaselines at 257^2 and 513^2 (ours_mixed and
     ours_fp64 l2 within 2% of scipy_spsolve's, scipy_cg, no pyamg or
     petsc row; _assemble_csr's host seconds at 513^2); MultigridProfiler
     on the 1025^2 fp32 hierarchy (A launched by the level-0 smooth stage;
     GB/s and share of 3.35 TB/s per stage, the bottleneck); a
     trace_profile of one 1025^2 'mixed' solve written; system_info.
The kernels' JSON record gives each kernel's bound: its compulsory bytes
(each input read once, each output written once) over the H100's published
3.35 TB/s, or its fp32 operations over 67 TFLOP/s, whichever is larger.
The second-to-last line is the kernels' JSON record, the last line the
device record. Any failure exits non-zero.

With --against DIR [DIR ...] it instead times this checkout against other
commits of the port, each unpacked into a DIR (for example ``git archive
<commit> | tar -x -C DIR``), in fresh processes whose import path holds one
tree each, taking turns DIR, this, this, DIR for each DIR. A set is: E's
2-sweep call at 513^3 (CUDA events, device time per launch, launches per
call); F's 513^3 -> 257^3 and G's 257^3 -> 513^3 call and u.mul_(2.0) at
513^3 (CUDA events, device time per launch); E's 2-sweep call and F's
513^3 -> 257^3 call on bf16 (device time per launch); the copy and torch.mul at
1025^2 and 8192^2 (CUDA events, device time per launch); the host time to
enqueue kernel A's 2-sweep call at 1025^2 (minimum over 5 x 200 calls) and
its CUDA-event time; A's and L's device time per 2-sweep call at 1025^2,
513^2 and 257^2 (every device op of a call), and K's and its launches per
call on the planes of the 1025^2 and 513^2 fields; D's CUDA-event and
device time per launch from 129^2 on the main path's tail; the 1025^2
main-path solve (FMG, IR; minimum of 5 after a warm-up, one right-hand
side); ir_solve3d at
513^3 (fp32 levels, tol 1e-9): wall ms per solve (minimum over 3 repeats of
2 right-hand sides), peak device memory, E's launches and the outer steps;
the BF16_3D_ITERS-cycle 513^3 'bf16' mg_solve3d (right-hand side on the
card, ms per solve, minimum of 3);
H's 2-sweep call at 1025^2 and J from 129^2 on the jump hierarchy (CUDA
events, device time per call or launch, H's host time per call and launches
per call) and H's device time per call at 513^2 and 257^2; the varcoef and
jump solve_poisson calls (ms per solve, minimum over 3 after a warm-up).
With --2d a set is its 2D Poisson part alone (kernels A, D, K, L and the
main path). Only entry points both trees have are called. It prints one JSON
line per set and a summary.

Usage: python3 chip_smoke.py [--against DIR [DIR ...] [--2d]]
       (needs one CUDA card; imports no JAX)
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

N = 1025
K = 16                    # right-hand sides per timed batch (bench.py)
REPEATS = 5
ITERS_EXPECTED = 3        # outer steps of the JAX reference at 1025^2
L2_EXPECTED = 3.92e-7     # its l2 error against the exact solution
L2_RTOL = 0.02
PATH_ATOL = 1e-8          # max|u_kernels - u_plain| after the solve
# Kernel vs plain twin, relative to max|twin|: both compute in fp32, but the
# kernels multiply by 1/c where the twin divides by c, nvcc contracts
# multiply-adds into FMAs, and the tail chains ~100 dependent phases.
KERNEL_RTOL = 1e-5
FREQS = [(1, 1), (2, 1), (1, 3), (3, 2), (2, 5), (5, 1), (4, 3), (1, 7)]
N3 = 513
# Outer steps of the JAX reference's solve_poisson3d(fp32, tol 1e-9) on the
# CPU: 5 at 129^3 and at 257^3 (histories agree to 1%); the card is held to
# it at 257^3 and at 513^3.
ITERS3D_EXPECTED = 5
# l2 error of the 7-point solution: |3 pi^2 / lambda_h - 1| / sqrt(8) with
# lambda_h = (12/h^2) sin^2(pi h / 2)
L2_3D_EXPECTED = {257: 4.4371e-6, 513: 1.1093e-6}
# max|u_kernels - u_plain| after the 3D solve: both paths stop at 1e-9
# relative residual, which bounds their distance to the discrete solution
# far below this
PATH3D_ATOL = 1e-8
REFINE_NORM_RTOL = 1e-13  # N's norms: its sums' order differs from torch.sum
N3_REF = 257             # the largest size the JAX reference ran
SIZES3 = (N3, N3_REF, 129, 5)   # where E, F and G meet their twins
K3, K3_PLAIN, REPEATS3 = 4, 2, 3   # 3D right-hand sides and repeats
FREQS3 = [(1, 1, 1), (2, 1, 1), (1, 3, 2), (3, 2, 1)]
# The variable-coefficient and Robin path at 1025^2. The references are the
# JAX package's solve_poisson(precision='fp32', cfg=MultigridConfig(
# smoother='rbgs', omega=1.0, tol=1e-9)) on the CPU at 1025^2: varcoef 4
# outer steps, l2 4.2673e-6; jump 15 steps; Robin 3 steps, l2 1.2164e-8.
N_VAR = 1025
VAR_STEPS = {"varcoef": 4, "jump": 15, "robin": 3}
VAR_STEPS_SLACK = {"varcoef": 0, "jump": 1, "robin": 1}
VAR_L2 = {"varcoef": 4.2673e-6, "robin": 1.2164e-8}
ROBIN_L2_FACTOR = 1.5     # Robin: l2 <= this * the reference (the
                          # tolerance, not the grid, sets that l2)
VAR_PATH_RTOL = 1e-8      # max|u_auto - u_torch| <= this * max|u|
VAR_UPPER_LEVELS = 3      # 1025^2, 513^2, 257^2 smooth with H above the tail
# Targets of the redesigned H and J on the H100 (device time): H per 2-sweep
# RB-GS call at 1025^2, its copy-back included; J per launch from 129^2.
H_TARGET_MS, J_TARGET_MS = 0.020, 0.060
# The parity paths. plane_ir_solve at 1025^2 without FMG: the JAX
# package's plane A/B reached 4 outer steps on both arms
# (reports/plane_ab.json); its l2 is the main path's.
PLANE_ITERS_EXPECTED = 4
PLANE_PATH_ATOL = 1e-8    # max|du| plane path vs plain path and standard IR
N_COPY_HBM = 8192         # copy at 2 x 268 MB, far beyond the 50 MB L2
IR_INNER_CYCLES = 2       # cycles per outer step of solve_poisson3d
# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth
# and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The rest of the 2D operator at 1025^2 (phases 20-22). The references are
# the JAX package's solve_poisson(precision='fp32', cfg=MultigridConfig(
# smoother='rbgs', omega=1.0, tol=1e-9) with the case's changes) on the CPU
# at 1025^2: outer steps and l2 error against the exact solution. The
# periodic l2 is that of the JAX solution after periodic_sync (the JAX
# ir_solve leaves its duplicate nodes at the zero start; this port syncs
# them). The segment problems' factor grows with h (0.37 and 0.42 at
# 1025^2), so their counts get +-1, and the 1e-9 tolerance, not the grid,
# sets their l2 (at most ROBIN_L2_FACTOR x the reference, as for Robin).
OPERATOR_CASES = {
    # name: (problem, config changes, steps, slack, l2, l2 check)
    "W": ("poisson_mms_sinsin", dict(cycle="W"), 4, 0, 3.92183e-7, "rtol"),
    "F": ("poisson_mms_sinsin", dict(cycle="F"), 4, 0, 3.92183e-7, "rtol"),
    "periodic": ("periodic_helmholtz_mms", {}, 4, 0, 1.5505e-6, "rtol"),
    "segments": ("mixed_segment_problem", {}, 17, 1, 1.9107e-8, "factor"),
    "segment_mms": ("mixed_segment_mms", {}, 19, 1, 3.8250e-8, "factor"),
    "line_y": ("poisson_mms_anisotropic", dict(smoother="line_y"), 4, 0,
               1.24018e-7, "rtol"),
    "adi": ("poisson_mms_anisotropic", dict(smoother="adi"), 4, 0,
            1.24019e-7, "rtol"),
    "chebyshev": ("poisson_mms_sinsin", dict(smoother="chebyshev"), 5, 0,
                  3.92174e-7, "rtol"),
}
OPERATOR_PATH_RTOL = 1e-8  # max|u_auto - u_torch| <= this * max|u|
# Precision staging and domains at 1025^2 (phases 23-24). The references
# are the JAX package's solve_poisson (and refinement.adaptive_solve with
# start=BF16) with MultigridConfig(smoother='rbgs', omega=1.0, tol=1e-9)
# on the CPU at 1025^2: outer steps (iterations for the adaptive solves)
# and l2 error against the exact solution. 'mixed' with the kernels is
# expected at 4 steps, the fp32 count: kernel D computes the bf16 levels
# 33^2 and below in fp32.
PRECISION_REF = {"mixed": (5, 3.921825e-7), "adaptive": (15, 3.920405e-7),
                 "bf16_start": (16, 3.921676e-7)}
BF16_CHUNK = 5  # adaptive_solve's chunk: the bf16 stage's cycles
# The bf16-start solve through the kernels' twins, which round once per
# call as the kernels do: iterations and switches of
# benchmarking/bf16_start_witness.py (backend 'auto', CPU, 1025^2). The
# kernel path is held to it, the plain path to PRECISION_REF.
BF16_START_TWINS = (20, [(5, "fp32"), (15, "ir")])
DOMAIN_REF = {"corner_singularity": (3, 1.382196e-7),
              "l_shaped": (5, 9.045746e-6)}
# Galerkin coarsening and the Krylov solvers (phases 25-26). The references
# are the JAX package's runs on the CPU at the same size and configuration:
# phase 25, solve_poisson(P.<problem>(1025), precision='fp32',
# cfg=MultigridConfig(smoother='rbgs', omega=1.0, tol=1e-9,
# coarsening='galerkin')): outer steps and, with an exact solution, its l2.
GALERKIN_REF = {"jump_coefficient_problem": (5, None),
                "poisson_mms_sinsin": (4, 3.92183e-7)}
# Phase 26: krylov.<solver>(stencil_matvec(make_stencil(grid, spec, a=a,
# dtype=float64), unknown), where(unknown, rhs, 0), precond=<M>, tol=<tol>)
# with default maxiter (500; gmres 300, restart 30): iterations, converged
# and l2 against the exact solution. FGMRES tests the true residual
# b - A x, whose fp64 floor at 1025^2 (1.4e-6 in the JAX run, 2.8e-6 in the
# port's on the CPU, above 3.5e-6 on the card) lies at tol 1e-10 (3.5e-6):
# it is held at 1e-9, where both references take 30. 'mg' is multigrid_preconditioner over
# build_hierarchy(dtype='float32', cfg=MultigridConfig(smoother='rbgs',
# omega=1.0, symmetric=True)) on poisson_mms_exponential(1025); 'galerkin'
# the same with coarsening='galerkin' on jump_coefficient_problem(1025);
# the plain ones on poisson_mms_exponential(257): diagonal(st, unknown),
# chebyshev(st, unknown, degree=4, grid=grid), block_line(st, unknown,
# axis=0); 'mg3d' pcg with stencil_matvec3d(make_stencil3d(grid, spec,
# dtype=float64), unknown) and multigrid_preconditioner3d over
# build_hierarchy3d(dtype='float32', cfg as 'mg') on
# poisson3d_mms_sinsinsin(257).
KRYLOV_REF = {
    # name: (solver, preconditioner, n, tol, iterations, converged, l2)
    "mg_pcg": ("pcg", "mg", 1025, 1e-10, 7, True, 7.455375e-7),
    "mg_fcg": ("fcg", "mg", 1025, 1e-10, 7, True, 7.455375e-7),
    "mg_gmres": ("gmres", "mg", 1025, 1e-9, 30, True, 7.455375e-7),
    "galerkin_pcg": ("pcg", "galerkin", 1025, 1e-10, 8, True, None),
    "bicgstab_diagonal": ("bicgstab", "diagonal", 257, 1e-10, 500, False,
                          1.192845e-5),
    "pcg_chebyshev": ("pcg", "chebyshev", 257, 1e-10, 231, True,
                      1.192859e-5),
    "pcg_block_line": ("pcg", "block_line", 257, 1e-10, 500, False,
                       1.192859e-5),
    "mg3d_pcg": ("pcg", "mg3d", 257, 1e-10, 8, True, 4.437076e-6),
}
RAP_RTOL = 1e-12          # the card's RAP chain against the CPU's (fp64)
TAIL_ENTRY = 129           # dispatch.TAIL_MAX_ENTRY: D takes V entries <= it
# The heat equations (phases 27-28). Runs (the same table as
# scripts/heat_reference.py): problem, n, scheme, dtype, t_final, dt,
# n_steps, config changes; the default HeatConfig otherwise (rbgs, omega 1,
# cycles_per_step 2, step_rtol 1e-9, max_cycles_per_step 12). 'explicit'
# takes 10 steps at 0.9 x the stability limit.
HEAT_RUNS = {
    "cn": ("pure_diffusion", N, "crank_nicolson", "float32", 1e-3, 1e-4,
           None, {}),
    "bdf2": ("pure_diffusion", N, "bdf2", "float32", 1e-3, 1e-4, None, {}),
    "be": ("pure_diffusion", N, "backward_euler", "float32", 5e-4, 1e-4,
           None, {}),
    "explicit": ("pure_diffusion", N, "explicit", "float32", None, None, 10,
                 {}),
    "neumann": ("neumann_heat", N, "crank_nicolson", "float32", 5e-4, 1e-4,
                None, {}),
    "varcoef": ("varcoef", N, "crank_nicolson", "float32", 5e-4, 1e-4,
                None, {}),
    "cn_fp64": ("pure_diffusion", N, "crank_nicolson", "float64", 2e-2,
                2e-3, None, {}),
    "adaptive_fp64": ("pure_diffusion", 257, "crank_nicolson", "float64",
                      0.05, 0.005, None, {"adaptive_dt": True,
                                          "dt_tol": 1e-5}),
}
# fp64 runs: the JAX package's steps and l2 on the CPU at the same size
# (scripts/heat_reference.py); the card is held to the steps and to the l2
# within L2_RTOL.
HEAT_REF = {"cn_fp64": (10, 1.717379e-5), "adaptive_fp64": (13, 2.370413e-5)}
# fp32 runs: l2 at most this, 1.5 x the larger of the JAX package's and the
# port's plain path's l2 on the CPU (scripts/heat_reference.py): an fp32
# step sits on its rounding noise, and XLA's FMAs and torch's roundings
# give different noise (the port's CN l2 is 2.05x JAX's).
HEAT_L2_BOUND = {"cn": 1.6159e-6, "bdf2": 1.6220e-6, "be": 7.9350e-6,
                 "explicit": 1.4495e-7, "neumann": 9.2146e-7,
                 "varcoef": 2.3047e-6}
# kernel path against plain path, max|du| <= this * max|u|, on runs through
# A-D (A-D multiply by 1/c where their twins divide; the port's plain path
# on the CPU differs from JAX's by up to 4.0e-6 at 1025^2); runs through
# H-J, I and C alone, or no kernel are held bit for bit
HEAT_PATH_RTOL = 2e-5
HEAT_CYCLES_FP32 = 12     # a default fp32 step runs max_cycles_per_step
# 3D (phase 28): oscillating3d, fp32, cycles_per_step 2: name: (n, scheme,
# t_final, dt). The 257^3 l2 bounds are 1.5 x the larger of the JAX
# package's and the port's plain l2 on the CPU (scripts/heat_reference.py
# 3d: CN 2.154719e-7 and 5.073197e-7, BDF2 2.228723e-6 and 2.869290e-6).
# No reference reaches 513^3 (a CPU run of that size is out of reach), and
# the 257^3 bound does not carry over: two fp32 V-cycles per step leave an
# error that grows with n (the residual's rounding, ~2^-24 * 6/h^2 * |u|,
# against F ~ lam * u), 1.275619e-5 at 513^3 on both paths of the card
# against 4.945241e-7 at 257^3 (fp64: 1.122877e-6). The 513^3 bound is 1.5 x
# that plain-path value, a tripwire for regressions; the kernel path is
# held to the plain path bit for bit beside it.
HEAT3D_RUNS = {"cn": (N3, "crank_nicolson", 1e-2, 1e-3),
               "cn_257": (N3_REF, "crank_nicolson", 1e-2, 1e-3),
               "bdf2": (N3_REF, "bdf2", 1e-2, 1e-3)}
HEAT3D_L2_BOUND = {"cn": 1.9134e-5, "cn_257": 7.6098e-7, "bdf2": 4.3039e-6}
# The rest of 3D (phases 29-31). Phase 30: solve_poisson3d(
# poisson3d_mms_sinsinsin(n), precision=..., cfg=MultigridConfig(
# smoother='rbgs', omega=1.0, tol=1e-9)). 'mixed' (fp32 levels 513^3-65^3,
# bf16 33^3-3^3) is held to the count of its kernels' twins on the CPU at
# 513^3 (benchmarking/mixed3d_witness.py, backend 'auto'), which is the JAX
# package's count at 129^3 and 257^3 (scripts/reference3d.py), and to the
# fp32 path's l2; 'bf16' runs BF16_3D_ITERS cycles; 'adaptive' at 257^3 is
# held to the JAX package's iterations, l2 and switches.
# Phase 29's bf16 alignment shapes: E at nz even and odd, F at
# an odd nz whose tiles do not divide the grid (F takes odd sizes only)
E_PAIR_SHAPES = ((37, 66, 70), (33, 34, 131))
F_PAIR_SHAPES = ((37, 69, 131),)
MIXED3D_TWINS = 5
MIXED3D_L2 = L2_3D_EXPECTED[N3]
BF16_3D_ITERS = 8
PRECISION3D_REF = {"adaptive": (13, 4.437066e-6, [[10, "ir"]])}
# Phase 31: solve_poisson3d(P.<problem>(n), precision='fp32', the config
# above with the case's changes): name: (problem, n, changes); references
# (outer steps, l2 or None) from the JAX package on the CPU
# (scripts/reference3d.py). The 513^3 jump solve has no reference of its
# size (a CPU run of it is out of reach); the JAX package's count grows
# with n (10, 11, 13 at 65^3, 129^3, 257^3), and the card is held to its
# own first reading, 15 (a tripwire). The Galerkin reference runs the JAX
# package's solver on RAP levels the port computed (the script's note).
OPERATOR3D_CASES = {
    "jump": ("jump_coefficient3d", N3, {}),
    "neumann": ("neumann3d_test", N3_REF, {}),
    "periodic": ("periodic3d_helmholtz", N3_REF, {}),
    "line_z": ("anisotropic3d_z", N3_REF, {"smoother": "line_z"}),
    "w": ("poisson3d_mms_sinsinsin", N3_REF, {"cycle": "W"}),
    "galerkin": ("jump_coefficient3d", N3_REF, {"coarsening": "galerkin"}),
}
OPERATOR3D_REF = {"jump": (15, None), "neumann": (5, 4.454200e-6),
                  "periodic": (5, 1.759993e-5), "line_z": (4, 1.403126e-6),
                  "w": (4, 4.437076e-6), "galerkin": (5, None),
                  "heat_a": (5, 6.182821e-2)}
# solve_heat3d CN, fp64, on pure_diffusion3d(257) with a = 1 + x + y + z
HEAT3D_A_STEPS, HEAT3D_A_DT = 5, 1e-3
# bf16 storage in H, I, J and L and the 2D variable-coefficient precisions
# at 1025^2 (phases 32-33), on var_problems with MultigridConfig(
# smoother='rbgs', omega=1.0, tol=1e-9); 'bf16' runs BF16_VAR_CYCLES cycles
# (a uniform bf16 hierarchy cannot reach that tolerance; its l2 grows).
# VAR_PRECISION_REF: the JAX package on the CPU at 1025^2 (steps, l2 or
# None, switches; scripts/reference_var_precision.py), the plain path's
# reference. VAR_PRECISION_TWINS: the port's kernel twins on the CPU at
# 1025^2 (backend 'auto': the same script's column, or
# benchmarking/bf16_start_witness.py --problems varcoef,jump,robin
# --precisions mixed,bf16,bf16_start), which round once per call as the
# kernels do: the kernel path's reference.
BF16_VAR_CYCLES = 8
# Phase 32's bf16 row alignment cases of H and L: ny odd and even, fields
# narrower than a tile (windows clamped at both edges), the main path's
# 1025^2; storage offsets of (u, f, H's planes), 'alt' putting plane k at
# offset k % 2
BF16_ROW_SHAPES = ((70, 133), (69, 130), (1025, 1025), (5, 9), (9, 6))
BF16_ROW_OFFSETS = ((1, 1, 1), (0, 1, 0), (1, 0, "alt"))
VAR_PRECISION_REF = {
    ("varcoef", "mixed"): (5, 4.267189e-6, []),
    ("varcoef", "bf16"): (8, 4.662472e4, []),
    ("varcoef", "bf16_start"): (16, 4.267174e-6, [(5, "fp32"), (9, "ir")]),
    ("jump", "mixed"): (15, None, []),
    ("jump", "bf16"): (8, None, []),
    ("jump", "bf16_start"): (39, None, [(5, "fp32"), (20, "ir")]),
    ("robin", "mixed"): (3, 1.049221e-8, []),
    ("robin", "bf16"): (8, 2.809570e6, []),
    ("robin", "bf16_start"): (15, 1.017700e-4, [(1, "fp32"), (11, "ir")]),
}
VAR_PRECISION_TWINS = {
    ("varcoef", "mixed"): (5, 4.267189e-6, []),
    ("varcoef", "bf16"): (8, 3.603885e6, []),
    ("varcoef", "bf16_start"): (17, 4.267178e-6, [(5, "fp32"), (9, "ir")]),
    ("jump", "mixed"): (15, None, []),
    ("jump", "bf16"): (8, None, []),
    ("jump", "bf16_start"): (33, None, [(5, "fp32"), (15, "ir")]),
    ("robin", "mixed"): (3, 1.068658e-8, []),
    ("robin", "bf16"): (8, 2.821998e-1, []),
    ("robin", "bf16_start"): (15, 1.017700e-4, [(1, "fp32"), (11, "ir")]),
}
# halo_solve over NCCL (phase 34): solution within this of mg_solve's
HALO_ATOL = 1e-12
# the GSPMD path over NCCL (phase 35): fp64 solutions within this of the
# single-device plain solve's (the JAX package's sharded-solve bound)
SHARDED_ATOL = 1e-11
# Phase 36: the fp32 CN heat runs on the mesh of the world (pure_diffusion,
# dt 1e-4 at N^2, dt 1e-3 at N3_REF^3)
SHARDED_HEAT_STEPS = 5
SHARDED_HEAT3D_STEPS = 3
# The heat runs' fp32 states against the unhooked kernel path, where D's
# tail and the fused B/C (F/G) round otherwise than A (E) and the plain
# transfers the hook takes: fp32 rounding noise over 60 (1025^2) or 6
# (257^3) V-cycles, ~60 x 2^-24 at |u| <= 1 (2.742e-6 at 1025^2 on the
# first H100 run); the solves' fp64 outer states are held to PATH3D_ATOL
SHARDED_HEAT_ATOL = 1e-5
# Phase 37, the support layers: the MMS ladders (2D 'mixed', 3D fp32), the
# size of the two-grid factor, the suite's top size and the profiler's, and
# the baselines' sizes; all at tol 1e-9 (MMS; the suite's and baselines'
# own default is 1e-8)
SUPPORT_SIZES = (129, 257, 513, 1025)
SUPPORT_SIZES3D = (65, 129, 257)
SUPPORT_N = 1025
SUPPORT_H_SIZES = (257, 513, 1025)
SUPPORT_SUITE_SIZES = (257, 513, 1025)
SUPPORT_BASE_SIZES = (257, 513)
SUPPORT_ORDER_TOL = 0.3    # L2 order within 2 +- this
SUPPORT_RHO_MAX = 0.15     # the measured cycle factor, 'auto' and 'torch'
SUPPORT_RHO_ATOL = 0.01    # the two backends' factors within this
SUPPORT_ERR_RTOL = 0.02    # ours_* l2 error within this of scipy_spsolve's

PKG = "mixed_precision_multigrid_solvers_for_pdes_torch"
TPU_PKG = "mixed_precision_multigrid_solvers_for_pdes_tpu/ops/pallas_kernels"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def host_report() -> str:
    """The card line from nvidia-smi, after printing the host's tools."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}")
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc} ({ver})")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    print(f"ninja: {shutil.which('ninja')}")
    cutlass = "/usr/local/cutlass/include"
    print(f"cutlass headers: {cutlass if os.path.isdir(cutlass) else None}")
    return card


def clocks(label: str) -> None:
    """Print the card's SM and memory clocks and power draw now (nvidia-smi
    reads them; it sets nothing), beside a group of device-time readings."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"clocks before {label}: {smi.stdout.strip()}")


def compare(name, shape_label, kernel_fn, plain_fn, make_inputs, errs,
            exact=False):
    """Run kernel and twin on identical inputs; record and check the
    difference (zero when ``exact``)."""
    import torch

    out_k = kernel_fn(*make_inputs())
    out_p = plain_fn(*make_inputs())
    torch.cuda.synchronize()
    if out_k.shape != out_p.shape or not torch.isfinite(out_k).all():
        fail(f"{name} {shape_label}: non-finite or misshapen output")
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    print(f"check {name} {shape_label}: max_abs_err {err:.3e} "
          f"max_rel_err {err / max(scale, 1e-30):.3e}")
    if err > KERNEL_RTOL * max(scale, 1e-30) or (exact and err != 0.0):
        fail(f"{name} {shape_label}: kernel disagrees with its plain twin "
             f"({err:.3e}, allowed {0.0 if exact else KERNEL_RTOL} * "
             f"{scale:.3e})")
    errs[name] = max(errs.get(name, 0.0), err)


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 10) -> float:
    """Mean device time per launch of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn`` after a
    warm-up. A trace now and then holds no device events at all; such a
    trace is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and kernel in e.key]
        launches = sum(e.count for e in kernels)
        if launches:
            return (sum(e.self_device_time_total for e in kernels) / 1e3
                    / launches)
    fail(f"the profiler saw no {kernel} kernel in {reps} calls, three times")


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call of ``reps`` back-to-back calls of ``fn``,
    from CUDA events around calls queued behind a sleeping kernel, so the
    host's launch cost stays out of the reading (the gaps between the
    card's launches stay in). The sleep doubles until the host has queued
    every call before it ends."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if host_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        cycles *= 2
    fail(f"the host could not queue {reps} calls ahead of the card")


def device_ms_per_call(fn, reps: int = 10, kernel: str = None,
                       launches: int = 1) -> float:
    """Mean device time per call of ``fn``: every kernel and copy on the
    card in the profiled window (a wrapper's copies included), over
    ``reps`` calls after a warm-up; retried as ``device_ms`` is, and, with
    ``kernel``, until the trace holds the ``launches`` per call of the
    kernels whose name holds it. A trace can lose events: after three
    traces that do, the reading is ``queued_ms``'s, and says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernel is not None and sum(
                e.count for e in events if kernel in e.key) != \
                reps * launches:
            continue
        if events:
            return sum(e.self_device_time_total for e in events) / 1e3 / reps
    ms = queued_ms(fn, reps)
    print(f"device time: three traces lost device work (or not {launches} "
          f"{kernel} launches per call); CUDA events over {reps} queued "
          f"calls instead: {ms:.4f} ms per call")
    return ms


def tail_var_entries(mg, card, dev) -> dict:
    """J's device ms per launch on the jump hierarchy's tail from entries
    3, 5, ..., 129: the differences are each level's cost."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import tail as kt

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    prob = mg.jump_coefficient_problem(N_VAR, 1e3)
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, device=dev,
                                cfg=cfg)
    kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
              method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
              symmetric=cfg.symmetric)
    gen = torch.Generator(device=dev).manual_seed(1357)
    out = {}
    for entry in (3, 5, 9, 17, 33, 65, 129):
        tail = [lev for lev in levels if lev.grid.nx <= entry]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = 1e3 * torch.randn(shapes[0], generator=gen, device=dev)
        u = torch.zeros(shapes[0], device=dev)
        out[entry] = device_ms(lambda: kt.tail_vcycle_var(
            sts, u, f, shapes=shapes, **kw), "tail_var", reps=20)
    print("J device ms per launch by entry (jump tail): " + ", ".join(
        f"{e}^2 {ms:.4f}" for e, ms in out.items()) + f" [{card}]")
    return out


def smooth_var_per_call(mg, card, dev) -> dict:
    """H's device ms per 2-sweep RB-GS call (every device op of the call)
    and its launches per call, at 1025^2, 513^2 and 257^2 of the jump
    hierarchy."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_var as ksv

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    prob = mg.jump_coefficient_problem(N_VAR, 1e3)
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, device=dev,
                                cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(8642)
    out = {}
    for lev in levels[:3]:
        n, st = lev.grid.nx, lev.stencil
        u = torch.randn((n, n), generator=gen, device=dev)
        f = 1e3 * torch.randn((n, n), generator=gen, device=dev)
        call = lambda: ksv.multisweep_var(st, u, f, sweeps=2)  # noqa: E731
        before = ksv.multisweep_var.launches
        call()
        per_call = ksv.multisweep_var.launches - before
        out[n] = (device_ms_per_call(call, reps=20), per_call)
        print(f"H {n}^2 2-sweep RB-GS call: device {out[n][0]:.4f} ms per "
              f"call (every device op), {per_call} launches per call, tile "
              f"{ksv.tile(n, n)} [{card}]")
    return out


def var_transfer_device(mg, card, dev) -> float:
    """I's device ms per 1025^2 -> 513^2 call on the varcoef hierarchy."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import transfer as kx

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    prob = mg.variable_coefficient_mms(N_VAR)
    st = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, device=dev,
                            cfg=cfg)[0].stencil
    gen = torch.Generator(device=dev).manual_seed(531)
    u = torch.randn((N_VAR, N_VAR), generator=gen, device=dev)
    f = 1e3 * torch.randn((N_VAR, N_VAR), generator=gen, device=dev)
    ms = device_ms_per_call(lambda: kx.residual_restrict_var(st, u, f), 20)
    print(f"I {N_VAR}->{(N_VAR - 1) // 2 + 1}: device {ms:.4f} ms per call "
          f"[{card}]")
    return ms


def at_offset(t, offset):
    """``t`` in a view at element ``offset`` of a larger storage of its
    dtype: at an odd offset a bf16 field starts in a word's upper half."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


def i_offset_checks(kx, st, u, f, label, errs, *, sides=None, out=None,
                    name="residual_restrict_var"):
    """I against its twin bit for bit on views at storage offsets 0 and 1:
    u at the offset, f at the other parity, the planes alternating (the
    difference taken in fp32)."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.stencil \
        import Stencil

    kw = dict(out_dtype=out) if sides is None else dict(sides=sides,
                                                        out_dtype=out)
    for off in (0, 1):
        sv = Stencil(*(at_offset(x, (k + off) % 2)
                       for k, x in enumerate(st.coefs)))
        uv, fv = at_offset(u, off), at_offset(f, 1 - off)
        compare(name, f"{label}, u at offset {off}",
                lambda a, b: kx.residual_restrict_var(sv, a, b,
                                                      **kw).float(),
                lambda a, b: kx.residual_restrict_plain(sv, a, b,
                                                        **kw).float(),
                lambda: (uv, fv), errs, exact=True)


def kernel_phase(levels, cfg, dev):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    rng = np.random.default_rng(1234)

    def field(shape, scale=1.0):
        a = np.zeros(shape, np.float32)
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
        return torch.from_numpy(a).to(dev)

    by_n = {lev.grid.nx: lev for lev in levels}
    errs, times = {}, {}
    sm = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=cfg.omega)
    for n in (1025, 513, 257):
        st = by_n[n].stencil
        u, f = field((n, n)), field((n, n), st.c)
        compare("smooth_multisweep", f"{n}^2", lambda a, b: ks.multisweep(
            st, a, b, **sm), lambda a, b: ks.multisweep_plain(st, a, b, **sm),
            lambda: (u.clone(), f), errs)
        times[("smooth_multisweep", n)] = (
            time_ms(lambda: ks.multisweep(st, u, f, **sm)),
            time_ms(lambda: ks.multisweep_plain(st, u, f, **sm)))
    for n in (1025, 513, 257):
        st, nc = by_n[n].stencil, (n - 1) // 2 + 1
        u, f = field((n, n)), field((n, n), st.c)
        compare("residual_restrict", f"{n}->{nc}",
                lambda a, b: kx.residual_restrict(st, a, b),
                lambda a, b: kx.residual_restrict_plain(st, a, b),
                lambda: (u, f), errs)
        times[("residual_restrict", n)] = (
            time_ms(lambda: kx.residual_restrict(st, u, f)),
            time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
        ec = field((nc, nc))
        ec[0, :] = 0.5  # a non-zero ring must interpolate too
        compare("prolong_correct", f"{nc}->{n}", kx.prolong_correct,
                kx.prolong_correct_plain, lambda: (ec, u.clone()), errs)
        times[("prolong_correct", n)] = (
            time_ms(lambda: kx.prolong_correct(ec, u)),
            time_ms(lambda: kx.prolong_correct_plain(ec, u)))
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)
    for entry in (129, 3):
        tail = [lev for lev in levels if lev.grid.nx <= entry]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = field(shapes[0], sts[0].c)
        u0 = torch.zeros(shapes[0], device=dev)
        compare("tail_vcycle", f"{entry}^2 L={len(tail)}",
                lambda a, b: kt.tail_vcycle(sts, a, b, shapes=shapes,
                                            **tail_kw),
                lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                                  **tail_kw),
                lambda: (u0.clone(), f), errs)
        times[("tail_vcycle", entry)] = (
            time_ms(lambda: kt.tail_vcycle(sts, u0.clone(), f, shapes=shapes,
                                           **tail_kw)),
            time_ms(lambda: kt.tail_vcycle_plain(sts, u0.clone(), f,
                                                 shapes=shapes, **tail_kw)))
    # D against the same cycle run through A, B and C launches: the tail
    # gate shut, the coarsest sweeps on A
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import dispatch
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import \
        multigrid
    lvl = next(k for k, lev in enumerate(levels) if lev.grid.nx <= 129)
    f = field(levels[lvl].grid.shape, levels[lvl].stencil.c)
    u0 = torch.zeros_like(f)
    got = dispatch.tail_vcycle(levels, lvl, u0.clone(), f, cfg)
    saved, dispatch.TAIL_MAX_ENTRY = dispatch.TAIL_MAX_ENTRY, 0
    try:
        ref = multigrid._cycle(levels, u0.clone(), f, lvl, cfg, "V")
    finally:
        dispatch.TAIL_MAX_ENTRY = saved
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    print(f"check tail_vcycle 129^2 against the A/B/C recursion: max_abs_err "
          f"{err:.3e} ({'bit for bit' if err == 0 else 'NOT bit for bit'})")
    if err > KERNEL_RTOL * ref.abs().max().item():
        fail(f"D disagrees with the A/B/C recursion ({err:.3e})")
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return errs, times


def main_path_device(levels, card):
    """Device time on the card (torch.profiler): A's and L's ms per 2-sweep
    call at 1025^2, 513^2 and 257^2 (every device op of the call) with A's
    and L's launches per call, B's and C's ms per call
    at 1025^2, and D's ms per launch on the main path's tail from entries
    3^2 .. 129^2 (the differences are each level's cost)."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(97)
    out = {}
    for lev in levels[:3]:
        n, st = lev.grid.nx, lev.stencil
        u = torch.randn((n, n), generator=gen, device=dev)
        f = st.c * torch.randn((n, n), generator=gen, device=dev)
        before = ks.multisweep.launches, ks.multisweep_parity.launches
        ks.multisweep(st, u, f, layout="direct")
        ks.multisweep_parity(st, u, f)
        per_call = (ks.multisweep.launches - before[0],
                    ks.multisweep_parity.launches - before[1])
        a = device_ms_per_call(lambda: ks.multisweep(st, u, f,
                                                     layout="direct"), 20)
        el = device_ms_per_call(lambda: ks.multisweep_parity(st, u, f), 20)
        out[("smooth_multisweep", n)], out[("smooth_parity", n)] = a, el
        print(f"A {n}^2 2-sweep RB-GS call: device {a:.4f} ms per call "
              f"(every device op), tile {ks.tile(n, n)}; L {el:.4f} ms per "
              f"call; launches per call A {per_call[0]}, L {per_call[1]} "
              f"[{card}]")
        if per_call != (len(ks.plan_passes(2)),) * 2:
            fail(f"A and L made {per_call} launches in a 2-sweep call at "
                 f"{n}^2")
        if n == N:
            nc = (n - 1) // 2 + 1
            ec = torch.randn((nc, nc), generator=gen, device=dev)
            out[("residual_restrict", n)] = device_ms_per_call(
                lambda: kx.residual_restrict(st, u, f), 20)
            out[("prolong_correct", n)] = device_ms_per_call(
                lambda: kx.prolong_correct(ec, u), 20)
            print(f"B {n}->{nc}: device {out[('residual_restrict', n)]:.4f} "
                  f"ms per call; C {nc}->{n}: "
                  f"{out[('prolong_correct', n)]:.4f} ms per call [{card}]")
    cfg_kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
                  symmetric=False)
    entries = {}
    for entry in (3, 5, 9, 17, 33, 65, 129):
        tail = [lev for lev in levels if lev.grid.nx <= entry]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = sts[0].c * torch.randn(shapes[0], generator=gen, device=dev)
        u = torch.zeros(shapes[0], device=dev)
        entries[entry] = device_ms(lambda: kt.tail_vcycle(
            sts, u, f, shapes=shapes, **cfg_kw), "tail_vcycle", reps=20)
    print("D device ms per launch by entry (main tail): " + ", ".join(
        f"{e}^2 {ms:.4f}" for e, ms in entries.items()) + f" [{card}]")
    out[("tail_vcycle", 129)] = entries[129]
    return out


def main_path_launches(levels, cfg, iterations):
    """(A's, D's) launches in one main-path solve, FMG then ``iterations``
    outer steps of IR_INNER_CYCLES cycles: FMG starts one cycle from every
    level and the outer steps theirs from level 0; a cycle started above
    the tail smooths twice on each level above the tail down to the tail
    (A's planned passes per call) and launches D once, one started in the
    tail launches D once."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks

    upper = sum(lev.grid.nx > 129 for lev in levels)
    per_cycle = (len(ks.plan_passes(cfg.pre_sweeps))
                 + len(ks.plan_passes(cfg.post_sweeps)))
    starts = [1] * upper
    starts[0] += iterations * IR_INNER_CYCLES
    a = sum(n * per_cycle * (upper - lvl) for lvl, n in enumerate(starts))
    return a, len(levels) - upper + sum(starts)


def solve(mg, levels, prob, cfg, f, dev):
    import torch

    u0 = prob.initial_guess(torch.float64, dev)
    return mg.ir_solve(levels, f, u0, cfg, inner_cycles=2, max_outer=100,
                       use_fmg=True)


def timed_solves(mg, levels, prob, cfg, dev) -> float:
    """bench.py's protocol: K frequency-swept right-hand sides, each solved
    from a zero guess; min over REPEATS of the mean per-solve wall time."""
    import torch

    g = prob.grid
    X, Y = np.meshgrid(np.arange(N) * g.hx, np.arange(N) * g.hy,
                       indexing="ij")

    def batch(r):
        out = []
        for i in range(K):
            kx, ky = FREQS[i % len(FREQS)]
            amp = 1.0 + (i + r * K) / (K * 8.0)
            out.append(torch.from_numpy(
                amp * (kx**2 + ky**2) * np.pi**2 * np.sin(kx * np.pi * X)
                * np.sin(ky * np.pi * Y)).to(dev))
        return out

    best = float("inf")
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        fs = batch(r)
        torch.cuda.synchronize()
        total = 0.0
        for fk in fs:
            t0 = time.perf_counter()
            _, info = solve(mg, levels, prob, cfg, fk, dev)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            if not info["converged"]:
                fail(f"timed solve (backend={cfg.backend}) did not converge")
        if r > 0:
            best = min(best, total / K)
    return best


def g_against_mul(u, ec, kx3, card) -> None:
    """G's call at 513^3 against the in-place yardstick u.mul_(2.0), which
    moves the same u bytes (G also reads ec), in turns (G mul mul G): CUDA
    events and device time per launch, each read in every turn."""
    calls = {"G": (lambda: kx3.prolong_correct3d(ec, u), "prolong_correct3d"),
             "u.mul_(2.0)": (lambda: u.mul_(2.0), "elementwise")}
    wall = {name: [] for name in calls}
    on_dev = {name: [] for name in calls}
    for name in ("G", "u.mul_(2.0)", "u.mul_(2.0)", "G"):
        fn, kernel = calls[name]
        wall[name].append(time_ms(fn, reps=20))
        on_dev[name].append(device_ms(fn, kernel))
    for name in calls:
        print(f"yardstick {N3}^3 in place {name}: {np.mean(wall[name]):.4f} "
              f"ms ({wall[name][0]:.4f}, {wall[name][1]:.4f}); device "
              f"{np.mean(on_dev[name]):.4f} ms per launch "
              f"({on_dev[name][0]:.4f}, {on_dev[name][1]:.4f}) [{card}]")
    ratio = np.mean(on_dev["G"]) / np.mean(on_dev["u.mul_(2.0)"])
    print(f"yardstick {N3}^3: G's device time is {ratio:.3f} x "
          f"u.mul_(2.0)'s (target <= 1.15) [{card}]")


def kernel_phase3d(dev, card):
    """Phase 7: kernels E, F, G against their twins at 513^3, 257^3, 129^3
    and 5^3 (bit for bit); inputs from a seeded generator on the card;
    device time per launch of E at 513^3, of F and G at 513^3 and 257^3,
    and G against its in-place yardstick at 513^3."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import Grid3D
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3, transfer3d as kx3

    gen = torch.Generator(device=dev).manual_seed(4321)

    def field(shape, scale=1.0, shell=False):
        a = scale * torch.randn(shape, generator=gen, device=dev)
        if not shell:
            inner = a[1:-1, 1:-1, 1:-1].clone()
            a.zero_()
            a[1:-1, 1:-1, 1:-1] = inner
        return a

    errs, times, dev_ms = {}, {}, {}
    for n in SIZES3:
        st = stencil3d.make_stencil3d(Grid3D(n, n, n))
        u, f = field((n,) * 3), field((n,) * 3, st.c)
        cases = [(2, 1.0, False), (1, 1.3, False), (2, 1.0, True)]
        if n == N3_REF:
            cases.append((3, 1.3, True))   # two launches: 2 + 1 sweeps
        if n < 17:
            cases.append((32, 1.0, False))  # the coarsest solve's sweeps
        for sweeps, omega, reverse in cases:
            kw = dict(sweeps=sweeps, omega=omega, reverse=reverse)
            compare("rbgs3d", f"{n}^3 {kw}",
                    lambda a, b: ks3.rbgs3d(st, a, b, **kw),
                    lambda a, b: ks3.rbgs3d_plain(st, a, b, **kw),
                    lambda: (u.clone(), f), errs, exact=True)
        times[("rbgs3d", n)] = (
            time_ms(lambda: ks3.rbgs3d(st, u, f, sweeps=2), reps=10),
            time_ms(lambda: ks3.rbgs3d_plain(st, u, f, sweeps=2), reps=10))
        if n == N3:
            dev_ms[("rbgs3d", n)] = device_ms(
                lambda: ks3.rbgs3d(st, u, f, sweeps=2), "rbgs3d")
        nc = (n - 1) // 2 + 1
        compare("residual_restrict3d", f"{n}->{nc}",
                lambda a, b: kx3.residual_restrict3d(st, a, b),
                lambda a, b: kx3.residual_restrict3d_plain(st, a, b),
                lambda: (u, f), errs, exact=True)
        times[("residual_restrict3d", n)] = (
            time_ms(lambda: kx3.residual_restrict3d(st, u, f), reps=10),
            time_ms(lambda: kx3.residual_restrict3d_plain(st, u, f),
                    reps=10))
        ec = field((nc,) * 3, shell=True)  # a non-zero coarse shell too
        compare("prolong_correct3d", f"{nc}->{n}", kx3.prolong_correct3d,
                kx3.prolong_correct3d_plain, lambda: (ec, u.clone()), errs,
                exact=True)
        times[("prolong_correct3d", n)] = (
            time_ms(lambda: kx3.prolong_correct3d(ec, u), reps=10),
            time_ms(lambda: kx3.prolong_correct3d_plain(ec, u), reps=10))
        if n in (N3, N3_REF):
            dev_ms[("residual_restrict3d", n)] = device_ms(
                lambda: kx3.residual_restrict3d(st, u, f),
                "residual_restrict3d")
            dev_ms[("prolong_correct3d", n)] = device_ms(
                lambda: kx3.prolong_correct3d(ec, u), "prolong_correct3d")
        if n == N3:
            g_against_mul(u, ec, kx3, card)
        del u, f, ec
        torch.cuda.empty_cache()
    st = stencil3d.make_stencil3d(Grid3D(3, 3, 3))  # the coarsest level
    u, f = field((3,) * 3), field((3,) * 3, st.c)
    compare("rbgs3d", "3^3 32 sweeps",
            lambda a, b: ks3.rbgs3d(st, a, b, sweeps=32),
            lambda a, b: ks3.rbgs3d_plain(st, a, b, sweeps=32),
            lambda: (u.clone(), f), errs, exact=True)
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^3: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    for (name, n), ms in dev_ms.items():
        print(f"device time {name} {n}^3: {ms:.4f} ms per launch "
              "(torch.profiler)")
    return errs, times, dev_ms


def refine_phase3d(dev, card):
    """Phase 7 (end): kernel N's step and start at 513^3 on card tensors,
    fp32 and bf16 level storage, against its twin: u_out and r_lo bit for
    bit, the two norms to REFINE_NORM_RTOL (N sums the squares in another
    order than torch.sum); CUDA-event ms of N's step and of the twin's
    (the plain step N replaced), and N's device time per launch."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import Grid3D
    from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import refine3d as kr3

    gen = torch.Generator(device=dev).manual_seed(2626)
    shape = (N3,) * 3
    g = Grid3D(*shape)
    h = (g.hx, g.hy, g.hz)
    errs, times, dev_ms = {}, {}, {}
    for lo in (torch.float32, torch.bfloat16):
        st = stencil3d.make_stencil3d(g, dtype=lo).astype(torch.float64)
        u = torch.randn(shape, dtype=torch.float64, device=dev,
                        generator=gen)
        e = (1e-3 * torch.randn(shape, device=dev, generator=gen)).to(lo)
        f = st.c * torch.randn(shape, dtype=torch.float64, device=dev,
                               generator=gen)
        out = torch.empty_like(u)
        r_lo = torch.empty(shape, dtype=lo, device=dev)
        scratch = kr3.new_scratch(shape, dev)
        for mode in ("step", "start"):
            ee = e if mode == "step" else None
            got = kr3.refine_step3d(st, u, ee, f, h=h, out=out, r_lo=r_lo,
                                    scratch=scratch)
            ref = kr3.refine_step3d_plain(st, u, ee, f, h=h,
                                          r_lo=torch.empty_like(r_lo))
            torch.cuda.synchronize()
            fields = [(got[1], ref[1])]
            if mode == "step":
                fields.append((got[0], ref[0]))
            err = max((a.double() - b.double()).abs().max().item()
                      for a, b in fields)
            rel = [abs(a.item() - b.item()) / abs(b.item())
                   for a, b in zip(got[2:], ref[2:]) if a is not None]
            print(f"check refine_step3d {N3}^3 {str(lo)[6:]} {mode}: "
                  f"max_abs_err {err:.3e} ("
                  f"{'u_out, r_lo' if mode == 'step' else 'r_lo'}), norms "
                  f"rel {['%.2e' % x for x in rel]}")
            if err != 0.0 or max(rel) > REFINE_NORM_RTOL:
                fail(f"refine_step3d {N3}^3 {lo} {mode}: not bit for bit "
                     f"({err:.3e}) or norms beyond {REFINE_NORM_RTOL}")
            errs["refine_step3d"] = max(errs.get("refine_step3d", 0.0), err)
            del got, ref
        if lo == torch.float32:
            step = lambda: kr3.refine_step3d(  # noqa: E731
                st, u, e, f, h=h, out=out, r_lo=r_lo, scratch=scratch)
            unknown = bc3d.unknown_mask3d(*shape, device=dev)
            twin = lambda: kr3.refine_step3d_plain(  # noqa: E731
                st, u, e, f, h=h, out=out, r_lo=r_lo, unknown=unknown)
            times[("refine_step3d", N3)] = (time_ms(step, reps=10),
                                            time_ms(twin, reps=5))
            dev_ms[("refine_step3d", N3)] = device_ms(step, "refine_step3d")
            k_ms, p_ms = times[("refine_step3d", N3)]
            print(f"time refine_step3d {N3}^3: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms; device {dev_ms[('refine_step3d', N3)]:.4f}"
                  f" ms per launch (torch.profiler) [{card}]")
        del st, u, e, f, out, r_lo, scratch
        torch.cuda.empty_cache()
    return errs, times, dev_ms


def solve3d(mg, n, backend, dev):
    """solve_poisson3d(precision='fp32', tol 1e-9) at n^3; returns the
    result and the peak device memory of the solve in bytes."""
    import torch

    prob = mg.poisson3d_mms_sinsinsin(n)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    torch.cuda.reset_peak_memory_stats(dev)
    res = mg.solve_poisson3d(prob, precision="fp32", cfg=cfg, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"solve3d {n}^3 {backend}: iterations {res.iterations} converged "
          f"{res.converged} history {res.info['history'].tolist()} "
          f"errors {res.errors} solve {res.solve_time * 1e3:.3f} ms "
          f"(first call, set-up included) peak memory {peak / 2**30:.3f} GiB")
    if tuple(res.u.shape) != (n,) * 3 or not torch.isfinite(res.u).all():
        fail(f"3D solution at {n}^3 is misshapen or not finite")
    if not res.converged or res.iterations != ITERS3D_EXPECTED:
        fail(f"3D {n}^3 {backend}: expected convergence in "
             f"{ITERS3D_EXPECTED} outer steps")
    if abs(res.errors["l2"] / L2_3D_EXPECTED[n] - 1) > L2_RTOL:
        fail(f"3D {n}^3 l2 error {res.errors['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {L2_3D_EXPECTED[n]:.4e}")
    return res, peak


def launches_per_cycle(mg, ks3, n, dev):
    """(E's, F's = G's) launches in one V-cycle of the n^3 solve: the
    launches E plans for each smoothing call over the solve's hierarchy, and
    one F and one G call per level above the coarsest (building it allocates
    no field)."""
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    *upper, coarsest = mg.build_hierarchy3d(mg.Grid3D(n, n, n),
                                           dtype="float32", device=dev,
                                           cfg=cfg)
    calls = [(lev.grid.shape, s) for lev in upper
             for s in (cfg.pre_sweeps, cfg.post_sweeps)]
    calls.append((coarsest.grid.shape, cfg.coarse_sweeps))
    return (sum(len(ks3.plan_passes(shape, s)) for shape, s in calls),
            len(upper))


def rhs3d(levels, i, r, k, dev):
    """Frequency-swept right-hand side number i of repeat r, on the card."""
    import torch

    g = levels[0].grid
    x = torch.arange(g.nx, dtype=torch.float64, device=dev) * g.hx
    kx, ky, kz = FREQS3[i % len(FREQS3)]
    amp = 1.0 + (i + r * k) / (k * 8.0)
    sx, sy, sz = (torch.sin(m * np.pi * x) for m in (kx, ky, kz))
    return (amp * (kx**2 + ky**2 + kz**2) * np.pi**2
            * sx[:, None, None] * sy[None, :, None] * sz[None, None, :])


def timed_solves3d(mg, levels, cfg, k, dev) -> float:
    """k frequency-swept right-hand sides, each solved by ir_solve3d from a
    zero guess; min over REPEATS3 of the mean per-solve wall time."""
    import torch

    u0 = torch.zeros(levels[0].grid.shape, dtype=torch.float64, device=dev)
    best = float("inf")
    for r in range(REPEATS3 + 1):  # r = 0 is the warm-up
        total = 0.0
        for i in range(k):
            f = rhs3d(levels, i, r, k, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = mg.ir_solve3d(levels, f, u0, cfg, inner_cycles=2)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            if not info["converged"]:
                fail(f"timed 3D solve (backend={cfg.backend}) did not "
                     "converge")
        if r > 0:
            best = min(best, total / k)
    return best


def profile_solve(label, run, wrappers, cpu: bool = True) -> None:
    """Profile one kernel-path solve (``run``): device-busy share against
    the same solve unprofiled, top kernels, launches per solve. ``cpu``
    False traces the device alone: the host events of a solve of ~10^5
    eager ops take the profiler a minute to aggregate, and only the device
    events are read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()
    wall = timed()
    for w in wrappers.values():
        w.launches = 0
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        wall_prof = timed()
    launches = {name: w.launches for name, w in wrappers.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_ops = sum(e.count for e in kernels)
    print(f"profile {label} kernel path: device time {dev_us / 1e3:.3f} ms "
          f"in {wall_prof * 1e3:.3f} ms profiled wall; unprofiled solve "
          f"{wall * 1e3:.3f} ms; device busy {dev_us / 1e6 / wall:.1%} of "
          f"the unprofiled solve; {n_ops} device ops per solve; custom "
          f"launches {launches}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  top kernel {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / max(dev_us, 1e-9):6.1%} "
              f"x{e.count:5d} {e.key[:90]}")


def var_problems(mg):
    """The three problems of the variable-coefficient and Robin path."""
    return {"varcoef": mg.variable_coefficient_mms(N_VAR),
            "jump": mg.jump_coefficient_problem(N_VAR, 1e3),
            "robin": mg.robin_test_problem(N_VAR)}


def kernel_phase_var(mg, cfg, dev):
    """Phase 11: H, I, C with sides and J against their twins at the
    path's shapes; inputs from a seeded generator on the card."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.core import bc
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv, tail as kt, transfer as kx

    gen = torch.Generator(device=dev).manual_seed(2468)

    def field(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    robin = bc.BCSide(bc.BCKind.ROBIN, alpha=1.0, beta=1.0)
    side_sets = {"dirichlet": bc.dirichlet(),
                 "east_robin": bc.BoundarySpec(east=robin),
                 "west_north_neumann": bc.mixed(west="neumann",
                                                north="neumann")}
    probs = var_problems(mg)
    grid = probs["varcoef"].grid
    hier = {name: mg.build_hierarchy(grid, spec, a=probs[coef].a,
                                     device=dev, cfg=cfg)
            for name, spec, coef in (
                ("varcoef", bc.dirichlet(), "varcoef"),
                ("jump", bc.dirichlet(), "jump"),
                ("east_robin", side_sets["east_robin"], "varcoef"),
                ("west_north_neumann", side_sets["west_north_neumann"],
                 "jump"))}
    errs, times = {}, {}
    smooth_cases = (("rbgs", 2, 1.0), ("rbgs_rev", 2, 1.0), ("sor", 1, 1.3),
                    ("jacobi", 2, 0.8))
    for coef in ("varcoef", "jump"):
        for lev in hier[coef][:3]:
            n, st = lev.grid.nx, lev.stencil
            u, f = field((n, n)), field((n, n), 1e3)
            for method, sweeps, omega in smooth_cases:
                kw = dict(method=method, sweeps=sweeps, omega=omega)
                compare("smooth_var", f"{coef} {n}^2 {kw}",
                        lambda a, b: ksv.multisweep_var(st, a, b, **kw),
                        lambda a, b: ks.multisweep_plain(st, a, b, **kw),
                        lambda: (u.clone(), f), errs)
            if coef == "varcoef":
                kw = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=1.0)
                times[("smooth_var", n)] = (
                    time_ms(lambda: ksv.multisweep_var(st, u, f, **kw)),
                    time_ms(lambda: ks.multisweep_plain(st, u, f, **kw)))
    for name in ("varcoef", "east_robin", "west_north_neumann"):
        levels = hier[name]
        sides = levels[0].spec.dirichlet_sides
        for k, lev in enumerate(levels[:-1]):
            n, st, nc = lev.grid.nx, lev.stencil, (lev.grid.nx - 1) // 2 + 1
            u, f = field((n, n)), field((n, n), 1e3)
            # I at every level size, bit for bit, on views at offsets 0, 1
            i_offset_checks(kx, st, u, f, f"{name} {n}->{nc}", errs,
                            sides=sides)
            if k >= 3:
                continue
            if name == "varcoef":
                times[("residual_restrict_var", n)] = (
                    time_ms(lambda: kx.residual_restrict_var(st, u, f)),
                    time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
            if name == "east_robin":
                ec = field((nc, nc))
                compare("prolong_correct", f"east_robin sides {nc}->{n}",
                        lambda a, b: kx.prolong_correct(a, b, sides=sides),
                        lambda a, b: kx.prolong_correct_plain(a, b,
                                                              sides=sides),
                        lambda: (ec, u.clone()), errs)
                times[("prolong_correct_sides", n)] = (
                    time_ms(lambda: kx.prolong_correct(ec, u, sides=sides)),
                    time_ms(lambda: kx.prolong_correct_plain(ec, u,
                                                             sides=sides)))
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)
    for coef in ("varcoef", "jump"):
        tail = [lev for lev in hier[coef] if lev.grid.nx <= 129]
        sts = [lev.stencil for lev in tail]
        shapes = [lev.grid.shape for lev in tail]
        f = field(shapes[0], 1e3)
        u0 = torch.zeros(shapes[0], device=dev)
        compare("tail_vcycle_var", f"{coef} 129^2 L={len(tail)}",
                lambda a, b: kt.tail_vcycle_var(sts, a, b, shapes=shapes,
                                                **tail_kw),
                lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                                  **tail_kw),
                lambda: (u0.clone(), f), errs)
        if coef == "varcoef":
            times[("tail_vcycle_var", 129)] = (
                time_ms(lambda: kt.tail_vcycle_var(
                    sts, u0.clone(), f, shapes=shapes, **tail_kw)),
                time_ms(lambda: kt.tail_vcycle_plain(
                    sts, u0.clone(), f, shapes=shapes, **tail_kw)))
        ms = device_ms(lambda: kt.tail_vcycle_var(
            sts, u0, f, shapes=shapes, **tail_kw), "tail_var", reps=20)
        print(f"device time tail_vcycle_var {coef} 129^2: {ms:.4f} ms per "
              f"launch (target <= {J_TARGET_MS})")
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return errs, times


def solve_var(mg, name, prob, backend, dev):
    """solve_poisson(precision='fp32', tol 1e-9) on one problem; checks
    the JAX reference's outer-step count and l2 error."""
    import torch

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
    print(f"solve_var {name} {N_VAR}^2 {backend}: iterations "
          f"{res.iterations} converged {res.converged} history "
          f"{res.info['history'].tolist()} errors {res.errors} solve "
          f"{res.solve_time * 1e3:.3f} ms (first call)")
    if tuple(res.u.shape) != (N_VAR, N_VAR) or \
            not torch.isfinite(res.u).all():
        fail(f"{name} solution is misshapen or not finite")
    if not res.converged or abs(res.iterations - VAR_STEPS[name]) > \
            VAR_STEPS_SLACK[name]:
        fail(f"{name} {backend}: expected convergence in {VAR_STEPS[name]} "
             f"+- {VAR_STEPS_SLACK[name]} outer steps")
    if name == "varcoef" and abs(res.errors["l2"] / VAR_L2[name] - 1) > \
            L2_RTOL:
        fail(f"varcoef l2 error {res.errors['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {VAR_L2[name]:.4e}")
    if name == "robin" and res.errors["l2"] > ROBIN_L2_FACTOR * VAR_L2[name]:
        fail(f"robin l2 error {res.errors['l2']:.4e} above "
             f"{ROBIN_L2_FACTOR} x {VAR_L2[name]:.4e}")
    return res


def timed_solves_var(mg, prob, backend, dev) -> float:
    """Min over REPEATS of one solve_poisson call's wall time (the
    hierarchy set-up included), after a warm-up."""
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend)
    best = float("inf")
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
        if not res.converged:
            fail(f"timed {prob.name} solve (backend={backend}) did not "
                 "converge")
        if r > 0:
            best = min(best, res.solve_time)
    return best


def var_path(mg, card, dev):
    """Phases 11-14; returns the kernels' errors, times and launch counts
    (H, I, J summed over the three kernel-path solves)."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_var as ksv, tail as kt, transfer as kx

    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    errs, times = kernel_phase_var(mg, cfg, dev)
    wrappers = {"smooth_var": ksv.multisweep_var,
                "residual_restrict_var": kx.residual_restrict_var,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle_var": kt.tail_vcycle_var}
    expected = {"varcoef": set(wrappers), "jump": set(wrappers),
                "robin": {"residual_restrict_var", "prolong_correct"}}
    launches = dict.fromkeys(("smooth_var", "residual_restrict_var",
                              "tail_vcycle_var"), 0)
    results = {}
    for name, prob in var_problems(mg).items():
        for w in wrappers.values():
            w.launches = 0
        results[name] = solve_var(mg, name, prob, "auto", dev)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"solve_var {name} auto launches {counts}")
        missing = [k for k in expected[name] if counts[k] <= 0]
        if missing:
            fail(f"kernels never launched on the {name} solve: {missing}")
        if name != "robin":
            # one J launch per cycle; H's planned launches for each of the
            # cycle's pre- and post-smoothing calls above the tail
            cycles = results[name].iterations * IR_INNER_CYCLES
            want = {"smooth_var": cycles * VAR_UPPER_LEVELS * len(
                        ksv.plan_passes(cfg.pre_sweeps)) * 2,
                    "tail_vcycle_var": cycles}
            print(f"solve_var {name}: H and J launches {counts['smooth_var']}"
                  f", {counts['tail_vcycle_var']}; planned {want}")
            if any(counts[k] != v for k, v in want.items()):
                fail(f"{name}: H and J launches {counts} differ from the "
                     f"plan {want}")
        for k in launches:
            launches[k] += counts[k]
    for name, prob in var_problems(mg).items():
        res_p = solve_var(mg, name, prob, "torch", dev)
        u_k = results[name].u
        du = (u_k - res_p.u).abs().max().item()
        scale = res_p.u.abs().max().item()
        print(f"solve_var {name}: max|u_auto - u_torch| {du:.3e} "
              f"(max|u| {scale:.3e})")
        if res_p.iterations != results[name].iterations or \
                du > VAR_PATH_RTOL * scale:
            fail(f"{name}: kernel and plain paths disagree (iterations "
                 f"{results[name].iterations} vs {res_p.iterations}, max "
                 f"diff {du:.3e} > {VAR_PATH_RTOL} * {scale:.3e})")
    del results
    torch.cuda.empty_cache()
    dofs = (N_VAR - 2) ** 2
    for name, prob in var_problems(mg).items():
        t_k = timed_solves_var(mg, prob, "auto", dev)
        t_p = timed_solves_var(mg, prob, "torch", dev)
        for label, t in (("kernels (auto)", t_k), ("plain (torch)", t_p)):
            print(f"solve_var time {name} {N_VAR}^2 {label}: "
                  f"{t * 1e3:.3f} ms per solve, {dofs / t:.6e} DoF/s "
                  f"[{card}]")
    jump = var_problems(mg)["jump"]
    profile_solve(f"{jump.name} {N_VAR}^2", lambda: mg.solve_poisson(
        jump, precision="fp32", cfg=cfg, device=dev), wrappers)
    return errs, times, launches


def kernel_phase_parity(levels, card, dev):
    """Phase 15: K, L and M against their twins; A, K and L in turns at
    1025^2; the copy's bandwidth. Returns errors, times, library times."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        planes as pln
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp

    rng = np.random.default_rng(97531)

    def field(n, scale=1.0, ny=None):
        ny = ny or n
        a = np.zeros((n, ny), np.float32)
        a[1:-1, 1:-1] = scale * rng.standard_normal((n - 2, ny - 2))
        return torch.from_numpy(a).to(dev)

    def stencil_of(nx, ny):
        from mixed_precision_multigrid_solvers_for_pdes_torch.core.grid \
            import Grid
        from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
            stencil
        return stencil.make_stencil(Grid(nx, ny))

    by_n = {lev.grid.nx: lev for lev in levels}
    errs, times, library, dev_ms = {}, {}, {}, {}
    # K and L on the main path's levels (K: the plane solve's level 0 and
    # 513^2), beyond MAX_SWEEPS (two launches) and on an odd-sided field
    # (K's planes then carry padding); the square 2-sweep calls timed
    k_cases = ((1025, 1025, ((2, 1.0), (2, 1.3)), True),
               (513, 513, ((2, 1.0), (2, 1.3), (5, 1.3)), True),
               (1000, 771, ((3, 1.3),), False))
    l_cases = ((1025, 1025, ((1, 1.0), (2, 1.0), (3, 1.0), (2, 1.3)), True),
               (513, 513, ((1, 1.0), (2, 1.0), (3, 1.0), (2, 1.3),
                           (5, 1.3)), True),
               (257, 257, ((1, 1.0), (2, 1.0), (3, 1.0), (2, 1.3)), True),
               (1000, 771, ((2, 1.3), (5, 1.0)), False))
    for n, ny, cases, timed in k_cases:
        st = by_n[n].stencil if timed else stencil_of(n, ny)
        up = pln.split_field(field(n, ny=ny))
        fp = pln.split_field(field(n, st.c, ny=ny))
        for sweeps, omega in cases:
            kw = dict(nx=n, ny=ny, sweeps=sweeps, omega=omega)
            compare("smooth_planes", f"({n}, {ny}) planes {kw}",
                    lambda a, b: kp.multisweep_planes(st, a, b, **kw),
                    lambda a, b: kp.multisweep_planes_plain(st, a, b, **kw),
                    lambda: (up.clone(), fp), errs, exact=True)
        if not timed:
            continue
        kw = dict(nx=n, ny=n, sweeps=2)
        before = kp.multisweep_planes.launches
        kp.multisweep_planes(st, up, fp, **kw)
        per_call = kp.multisweep_planes.launches - before
        times[("smooth_planes", n)] = (
            time_ms(lambda: kp.multisweep_planes(st, up, fp, **kw)),
            time_ms(lambda: kp.multisweep_planes_plain(st, up, fp, **kw)))
        dev_ms[("smooth_planes", n)] = device_ms_per_call(
            lambda: kp.multisweep_planes(st, up, fp, **kw), reps=20)
        print(f"K {n}^2 planes 2-sweep call: device "
              f"{dev_ms[('smooth_planes', n)]:.4f} ms per call (every "
              f"device op), {per_call} launches per call, tile "
              f"{ks.tile(n, n)} [{card}]")
        if per_call != len(ks.plan_passes(2)):
            fail(f"K made {per_call} launches in a 2-sweep call at {n}^2")
    for n, ny, cases, timed in l_cases:
        st = by_n[n].stencil if timed else stencil_of(n, ny)
        u, f = field(n, ny=ny), field(n, st.c, ny=ny)
        for sweeps, omega in cases:
            kw = dict(sweeps=sweeps, omega=omega)
            compare("smooth_parity", f"({n}, {ny}) {kw}",
                    lambda a, b: ks.multisweep_parity(st, a, b, **kw),
                    lambda a, b: ks.multisweep_parity_plain(st, a, b, **kw),
                    lambda: (u.clone(), f), errs, exact=True)
            compare("smooth_parity_vs_A", f"({n}, {ny}) {kw}",
                    lambda a, b: ks.multisweep_parity(st, a, b, **kw),
                    lambda a, b: ks.multisweep(st, a, b, layout="direct",
                                               **kw),
                    lambda: (u.clone(), f), errs, exact=True)
        if timed:
            times[("smooth_parity", n)] = (
                time_ms(lambda: ks.multisweep_parity(st, u, f)),
                time_ms(lambda: ks.multisweep_parity_plain(st, u, f)))
    for n in (513, 1025):
        u, f = field(n), field(n)
        for mode in kb.MODES:
            compare("probe", f"{mode} {n}^2",
                    lambda a, b: kb.probe(a, b, mode=mode),
                    lambda a, b: kb.probe_plain(a, b, mode=mode),
                    lambda: (u, f), errs, exact=True)
            times[(f"probe_{mode}", n)] = (
                time_ms(lambda: kb.probe(u, f, mode=mode)),
                time_ms(lambda: kb.probe_plain(u, f, mode=mode)))
        # a 2-sweep probe call is one launch (kernel A's scheme) that must
        # read u and f and write u once, 12 bytes per node; 'none' is A's
        # loads, stores and barriers with no neighbour reads
        bound_ms = 12 * n * n / HBM_BYTES_PER_S * 1e3
        for mode in kb.MODES:
            before = kb.probe.launches
            kb.probe(u, f, mode=mode)
            per_call = kb.probe.launches - before
            if per_call != 1:
                fail(f"the probe ({mode}) made {per_call} launches in a "
                     f"2-sweep call at {n}^2, its plan is 1")
            ms = dev_ms[(f"probe_{mode}", n)] = device_ms_per_call(
                lambda: kb.probe(u, f, mode=mode), reps=20, kernel="probe")
            print(f"M probe ({mode}) {n}^2 2-sweep call: device {ms:.5f} ms "
                  f"per call, {per_call} launch, bound {bound_ms:.5f} ms (12 "
                  f"bytes per node at 3.35 TB/s), {bound_ms / ms:.1%} of it "
                  f"[{card}]")
        reads = dev_ms[("probe_roll", n)] - dev_ms[("probe_none", n)]
        print(f"M probe {n}^2: roll - none {reads:.5f} ms per 2-sweep call "
              f"(the neighbour reads and the halo's loads) [{card}]")
        compare("copy", f"{n}^2", kb.copy2x, kb.copy2x_plain, lambda: (u,),
                errs, exact=True)
        times[("copy", n)] = (time_ms(lambda: kb.copy2x(u)),
                              time_ms(lambda: kb.copy2x_plain(u)))
        library[("copy", n)] = time_ms(lambda: torch.mul(u, 2.0))
        up, fp = pln.split_field(u), pln.split_field(f)
        compare("smooth_planes", f"parity probe (c = 4) {n}^2",
                lambda a, b: kb.parity(a, b, nx=n, ny=n),
                lambda a, b: kp.multisweep_planes_plain(
                    kb.PROBE_STENCIL, a, b, nx=n, ny=n),
                lambda: (up.clone(), fp), errs, exact=True)
        times[("parity_probe", n)] = (
            time_ms(lambda: kb.parity(up, fp, nx=n, ny=n)),
            time_ms(lambda: kp.multisweep_planes_plain(
                kb.PROBE_STENCIL, up, fp, nx=n, ny=n)))
    # A, K and L per 2-sweep call at 1025^2, in turns (A K L L K A)
    st = by_n[N].stencil
    u, f = field(N), field(N, st.c)
    up, fp = pln.split_field(u), pln.split_field(f)
    calls = {"A": lambda: ks.multisweep(st, u, f, layout="direct"),
             "K": lambda: kp.multisweep_planes(st, up, fp, nx=N, ny=N),
             "L": lambda: ks.multisweep_parity(st, u, f)}
    turns = {name: [] for name in calls}
    for name in ("A", "K", "L", "L", "K", "A"):
        turns[name].append(time_ms(calls[name], reps=50))
    print("turns at 1025^2, ms per 2-sweep call: " + ", ".join(
        f"{name} {np.mean(t):.4f} ({t[0]:.4f}, {t[1]:.4f})"
        for name, t in turns.items()) + f" [{card}]")
    # the copy and torch.mul in turns (copy mul mul copy): CUDA events and
    # device time per launch (torch.profiler), each read in every turn
    big = torch.randn(N_COPY_HBM, N_COPY_HBM, device=dev)
    compare("copy", f"{N_COPY_HBM}^2", kb.copy2x, kb.copy2x_plain,
            lambda: (big,), errs, exact=True)
    rates = {}
    calls = {"copy": kb.copy2x, "torch.mul": lambda a: torch.mul(a, 2.0)}
    kernel_of = {"copy": "copy2x", "torch.mul": "elementwise"}
    for label, arr in ((f"{N}^2", u), (f"{N_COPY_HBM}^2", big)):
        nbytes = 2 * arr.numel() * 4
        wall = {name: [] for name in calls}
        on_dev = {name: [] for name in calls}
        for name in ("copy", "torch.mul", "torch.mul", "copy"):
            fn = calls[name]
            wall[name].append(time_ms(lambda: fn(arr), reps=50))
            on_dev[name].append(device_ms(lambda: fn(arr), kernel_of[name],
                                          reps=20))
        for name in calls:
            t, d = float(np.mean(wall[name])), float(np.mean(on_dev[name]))
            print(f"copy bandwidth {label} fp32 (read + write "
                  f"{nbytes / 1e6:.1f} MB) {name}: {t:.4f} ms "
                  f"({wall[name][0]:.4f}, {wall[name][1]:.4f}), "
                  f"{nbytes / t / 1e6:.1f} GB/s; device {d:.4f} ms per "
                  f"launch ({on_dev[name][0]:.4f}, {on_dev[name][1]:.4f}), "
                  f"{nbytes / d / 1e6:.1f} GB/s [{card}]")
        rates[label] = nbytes / (float(np.mean(wall["copy"])) * 1e-3)
        dev_ms[("copy", arr.shape[0])] = float(np.mean(on_dev["copy"]))
    del big
    torch.cuda.empty_cache()
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
              + (f", library {library[(name, n)]:.4f} ms"
                 if (name, n) in library else ""))
    return errs, times, library, rates[f"{N_COPY_HBM}^2"], dev_ms


def parity_main_path(mg, levels, prob, cfg, f, u_direct, card, dev):
    """Phase 16: the main path with PARITY_DEFAULT on, and its profile;
    returns L's launches."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    wrappers = {"smooth_multisweep": ks.multisweep,
                "smooth_parity": ks.multisweep_parity,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    ks.PARITY_DEFAULT = True
    try:
        for w in wrappers.values():
            w.launches = 0
        u, info = solve(mg, levels, prob, cfg, f, dev)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        t = timed_solves(mg, levels, prob, cfg, dev)
        u0 = prob.initial_guess(torch.float64, dev)
        profile_solve(f"parity-layout main path {N}^2", lambda: mg.ir_solve(
            levels, f, u0, cfg, inner_cycles=2, max_outer=100, use_fmg=True),
            wrappers)
    finally:
        ks.PARITY_DEFAULT = False
    du = (u - u_direct).abs().max().item()
    print(f"solve auto, parity layout: iterations {info['iterations']} "
          f"history {info['history'].tolist()} launches {launches} "
          f"max|u_parity - u_direct| {du:.3e}; {t * 1e3:.3f} ms per solve, "
          f"{(N - 2) ** 2 / t:.6e} DoF/s [{card}]")
    l_plan = main_path_launches(levels, cfg, info["iterations"])[0]
    print(f"parity-layout main path: L {launches['smooth_parity']} launches "
          f"(plan {l_plan})")
    if launches["smooth_parity"] != l_plan or \
            launches["smooth_multisweep"] != 0:
        fail(f"the parity-layout main path must launch L {l_plan} times "
             f"and not A: {launches}")
    if not info["converged"] or info["iterations"] != ITERS_EXPECTED:
        fail(f"parity main path: expected convergence in {ITERS_EXPECTED} "
             "outer steps")
    if du != 0.0:
        fail(f"parity main path differs from the direct layout ({du:.3e}): "
             "L and A round every operation alike, so they must agree")
    return launches["smooth_parity"]


def microbench_path(card):
    """Phase 17: the microbenchmark, from launch counts reset to zero;
    returns the probe's and the copy's launches. The probe's calls: one
    launch each (2 sweeps), CUDA-event us per call beside the call's bound
    (12 bytes per node)."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb

    sweeps, reps = 2, 20
    kb.probe.launches = kb.copy2x.launches = 0
    rows = kb.run(sizes=(513, 1025), sweeps=sweeps, reps=reps)
    launches = {"probe": kb.probe.launches, "copy": kb.copy2x.launches}
    for n, row in rows.items():
        print(f"microbench {n}^2 (us per sweep; copy us per call) "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
              + f" [{card}]")
        bound_us = 12 * n * n / HBM_BYTES_PER_S * 1e6
        print(f"microbench {n}^2 probe per {sweeps}-sweep call (events, "
              f"host included): " + ", ".join(
                  f"{m} {row[f'probe_{m}'] * sweeps:.3f} us "
                  f"({bound_us / (row[f'probe_{m}'] * sweeps):.1%} of "
                  f"{bound_us:.3f})" for m in kb.MODES) + f" [{card}]")
    print(f"microbench launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"the microbenchmark did not launch kernel M: {launches}")
    # run() calls each probe mode reps + 1 times at each size, one launch a
    # call
    plan = 2 * len(kb.MODES) * (reps + 1)
    if launches["probe"] != plan:
        fail(f"the probe made {launches['probe']} launches in the "
             f"microbenchmark, one per call is {plan}")
    return launches


def plane_path(mg, card, dev):
    """Phases 18-19: plane_ir_solve at 1025^2; returns K's launches."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp, tail as kt, \
        transfer as kx

    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend="auto")
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    f = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    wrappers = {"smooth_planes": kp.multisweep_planes,
                "smooth_multisweep": ks.multisweep,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    for w in wrappers.values():
        w.launches = 0
    u, info = mg.plane_ir_solve(levels, f, u0, cfg, inner_cycles=2)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    err = prob.error_norms(u)
    print(f"plane solve auto: iterations {info['iterations']} converged "
          f"{info['converged']} history {info['history'].tolist()} l2 "
          f"{err['l2']:.6e} linf {err['linf']:.6e} launches {launches}")
    if tuple(u.shape) != (N, N) or not torch.isfinite(u).all():
        fail("plane solve: solution is misshapen or not finite")
    if not info["converged"] or info["iterations"] != PLANE_ITERS_EXPECTED:
        fail(f"plane solve: expected convergence in {PLANE_ITERS_EXPECTED} "
             "outer steps (the JAX reference's count)")
    if abs(err["l2"] / L2_EXPECTED - 1) > L2_RTOL:
        fail(f"plane solve: l2 error {err['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {L2_EXPECTED:.3e}")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the plane solve: {missing}")
    # level 0 smooths twice per cycle, IR_INNER_CYCLES cycles per outer step
    k_plan = info["iterations"] * IR_INNER_CYCLES * (
        len(ks.plan_passes(cfg.pre_sweeps))
        + len(ks.plan_passes(cfg.post_sweeps)))
    print(f"plane solve: K {launches['smooth_planes']} launches (plan "
          f"{k_plan})")
    if launches["smooth_planes"] != k_plan:
        fail(f"K made {launches['smooth_planes']} launches in the plane "
             f"solve, its plan {k_plan}")
    u_p, info_p = mg.plane_ir_solve(levels, f, u0, cfg.replace(
        backend="torch"), inner_cycles=2)
    u_s, info_s = mg.ir_solve(levels, f, u0, cfg, inner_cycles=2,
                              use_fmg=False)
    torch.cuda.synchronize()
    for label, (u_o, info_o) in (("plane torch", (u_p, info_p)),
                                 ("standard ir_solve no FMG",
                                  (u_s, info_s))):
        du = (u - u_o).abs().max().item()
        print(f"plane solve vs {label}: iterations {info_o['iterations']} "
              f"history {info_o['history'].tolist()} max|du| {du:.3e}")
        if info_o["iterations"] != info["iterations"] or \
                du > PLANE_PATH_ATOL:
            fail(f"plane solve disagrees with the {label} solve "
                 f"(iterations {info['iterations']} vs "
                 f"{info_o['iterations']}, max|du| {du:.3e} > "
                 f"{PLANE_PATH_ATOL})")
    del u_p, u_s
    runs = {"plane": lambda: mg.plane_ir_solve(levels, f, u0, cfg,
                                               inner_cycles=2),
            "standard": lambda: mg.ir_solve(levels, f, u0, cfg,
                                            inner_cycles=2, use_fmg=False)}
    best = dict.fromkeys(runs, float("inf"))
    for r in range(REPEATS + 1):  # r = 0 is the warm-up
        for name in (("plane", "standard") if r % 2 else
                     ("standard", "plane")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            if r > 0:
                best[name] = min(best[name], time.perf_counter() - t0)
    dofs = (N - 2) ** 2
    for name, t in best.items():
        print(f"solve time {name} no-FMG IR {N}^2: {t * 1e3:.3f} ms per "
              f"solve, {dofs / t:.6e} DoF/s [{card}]")
    k_planes = launches["smooth_planes"]
    profile_solve(f"plane solve {N}^2", runs["plane"], wrappers)
    return k_planes


def cycle_launches(levels, cfg, iterations):
    """A's, B's, C's and D's launches in one solve_poisson run: no FMG,
    ``iterations`` outer steps of IR_INNER_CYCLES cycles, walked from the
    cycle recursion. With a point smoother (Jacobi or RB-GS) a cycle of
    type V entered at a level of at most TAIL_ENTRY launches D once, and
    any other entry smooths twice through A (its planned passes per call);
    line, ADI and Chebyshev smoothing takes neither. Every entry above the
    coarsest transfers once through B and once through C, then enters the
    next level once (V), twice (W) or as F then V, while the level below
    is within ``cfg.w_depth``, and as V beyond; the coarsest level's 32
    RB-GS sweeps are A's planned passes for 32."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks

    sizes = [lev.grid.nx for lev in levels]
    point = cfg.smoother in ("jacobi", "rbgs")
    per_call = len(ks.plan_passes(cfg.pre_sweeps)) + len(
        ks.plan_passes(cfg.post_sweeps))
    count = dict.fromkeys(("smooth_multisweep", "residual_restrict",
                           "prolong_correct", "tail_vcycle"), 0)

    def walk(lvl, cycle):
        if point and cycle == "V" and sizes[lvl] <= TAIL_ENTRY:
            count["tail_vcycle"] += 1
            return
        if lvl == len(sizes) - 1:
            count["smooth_multisweep"] += len(ks.plan_passes(
                cfg.coarse_sweeps))
            return
        count["smooth_multisweep"] += per_call if point else 0
        count["residual_restrict"] += 1
        count["prolong_correct"] += 1
        branch = cycle if lvl + 1 < cfg.w_depth else "V"
        for nxt in {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}[branch]:
            walk(lvl + 1, nxt)

    walk(0, cfg.cycle)
    cycles = iterations * IR_INNER_CYCLES
    return {k: v * cycles for k, v in count.items()}


def operator_config(mg, name, backend):
    prob_name, changes = OPERATOR_CASES[name][:2]
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend=backend).replace(**changes)
    return getattr(mg, prob_name)(N), cfg


def operator_solve(mg, name, backend, dev):
    """solve_poisson(precision='fp32', tol 1e-9) on one case of phases
    20-22; checks the JAX reference's outer-step count and l2 error."""
    import torch

    prob, cfg = operator_config(mg, name, backend)
    _, _, steps, slack, l2_ref, rule = OPERATOR_CASES[name]
    res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
    print(f"solve {name} ({prob.name}) {N}^2 {backend}: iterations "
          f"{res.iterations} converged {res.converged} history "
          f"{res.info['history'].tolist()} errors {res.errors} solve "
          f"{res.solve_time * 1e3:.3f} ms (first call)")
    if tuple(res.u.shape) != (N, N) or not torch.isfinite(res.u).all():
        fail(f"{name} solution is misshapen or not finite")
    if not res.converged or abs(res.iterations - steps) > slack:
        fail(f"{name} {backend}: expected convergence in {steps} +- {slack}"
             " outer steps")
    l2 = res.errors["l2"]
    if rule == "rtol" and abs(l2 / l2_ref - 1) > L2_RTOL:
        fail(f"{name} l2 error {l2:.4e} not within {L2_RTOL:.0%} of "
             f"{l2_ref:.4e}")
    if rule == "factor" and l2 > ROBIN_L2_FACTOR * l2_ref:
        fail(f"{name} l2 error {l2:.4e} above {ROBIN_L2_FACTOR} x "
             f"{l2_ref:.4e}")
    return res


def kernel_phase_wf(mg, levels, cfg, dev):
    """The kernel checks of phases 20-22 at the entries no earlier phase
    gives them, against their twins: A at 129^2 and 65^2 (2 sweeps), B and C
    between 129^2 and 65^2 and D from 65^2 (the W and F cycles); A on the
    coarsest level (32 RB-GS sweeps, omega 1) of the anisotropic hierarchy
    and of the isotropic one, and B and C between 1025^2 and 513^2 with the
    anisotropic stencil (the line, ADI and Chebyshev paths)."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    gen = torch.Generator(device=dev).manual_seed(2020)

    def field(shape, scale=1.0):
        a = torch.zeros(shape, device=dev)
        a[1:-1, 1:-1] = scale * torch.randn(
            (shape[0] - 2, shape[1] - 2), generator=gen, device=dev)
        return a

    by_n = {lev.grid.nx: lev for lev in levels}
    errs, times = {}, {}
    sm = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=cfg.omega)
    for n in (129, 65):
        st = by_n[n].stencil
        u, f = field((n, n)), field((n, n), st.c)
        compare("smooth_multisweep", f"{n}^2 (W/F)", lambda a, b:
                ks.multisweep(st, a, b, **sm), lambda a, b:
                ks.multisweep_plain(st, a, b, **sm),
                lambda: (u.clone(), f), errs)
        times[("smooth_multisweep", n)] = (
            time_ms(lambda: ks.multisweep(st, u, f, **sm)),
            time_ms(lambda: ks.multisweep_plain(st, u, f, **sm)))
    st, n, nc = by_n[129].stencil, 129, 65
    u, f, ec = field((n, n)), field((n, n), st.c), field((nc, nc))
    compare("residual_restrict", f"{n}->{nc} (W/F)",
            lambda a, b: kx.residual_restrict(st, a, b),
            lambda a, b: kx.residual_restrict_plain(st, a, b),
            lambda: (u, f), errs)
    compare("prolong_correct", f"{nc}->{n} (W/F)", kx.prolong_correct,
            kx.prolong_correct_plain, lambda: (ec, u.clone()), errs)
    times[("residual_restrict", n)] = (
        time_ms(lambda: kx.residual_restrict(st, u, f)),
        time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
    times[("prolong_correct", n)] = (
        time_ms(lambda: kx.prolong_correct(ec, u)),
        time_ms(lambda: kx.prolong_correct_plain(ec, u)))
    tail = [lev for lev in levels if lev.grid.nx <= 65]
    sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                   for lev in tail]
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)
    f = field(shapes[0], sts[0].c)
    u0 = torch.zeros(shapes[0], device=dev)
    compare("tail_vcycle", f"65^2 L={len(tail)} (W/F)",
            lambda a, b: kt.tail_vcycle(sts, a, b, shapes=shapes, **tail_kw),
            lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                              **tail_kw),
            lambda: (u0.clone(), f), errs)
    times[("tail_vcycle", 65)] = (
        time_ms(lambda: kt.tail_vcycle(sts, u0.clone(), f, shapes=shapes,
                                       **tail_kw)),
        time_ms(lambda: kt.tail_vcycle_plain(sts, u0.clone(), f,
                                             shapes=shapes, **tail_kw)))
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2 (W/F entries): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
    prob, lcfg = operator_config(mg, "line_y", "auto")
    aniso = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                               device=dev, cfg=lcfg)
    coarse = dict(method="rbgs", sweeps=cfg.coarse_sweeps, omega=1.0)
    for label, lev in (("anisotropic", aniso[-1]), ("isotropic", levels[-1])):
        st, shape = lev.stencil, lev.grid.shape
        u, f = field(shape), field(shape, st.c)
        compare("smooth_multisweep", f"{shape[0]}^2 coarsest {label} "
                f"({cfg.coarse_sweeps} sweeps)", lambda a, b:
                ks.multisweep(st, a, b, **coarse), lambda a, b:
                ks.multisweep_plain(st, a, b, **coarse),
                lambda: (u.clone(), f), errs)
    st, n, nc = aniso[0].stencil, aniso[0].grid.nx, aniso[1].grid.nx
    print(f"anisotropic stencil {n}^2: c {st.c} w {st.w} e {st.e} s {st.s} "
          f"n {st.n}")
    u, f, ec = field((n, n)), field((n, n), st.c), field((nc, nc))
    compare("residual_restrict", f"{n}->{nc} (anisotropic)",
            lambda a, b: kx.residual_restrict(st, a, b),
            lambda a, b: kx.residual_restrict_plain(st, a, b),
            lambda: (u, f), errs)
    compare("prolong_correct", f"{nc}->{n} (anisotropic)",
            kx.prolong_correct, kx.prolong_correct_plain,
            lambda: (ec, u.clone()), errs)
    return errs


def timed_operator_solves(mg, name, backend, dev) -> float:
    """Min of 3 solve_poisson calls' wall time (the hierarchy set-up
    included); the checked solves of the same case were the warm-up."""
    prob, cfg = operator_config(mg, name, backend)
    best = float("inf")
    for _ in range(3):
        res = mg.solve_poisson(prob, precision="fp32", cfg=cfg, device=dev)
        if not res.converged:
            fail(f"timed {name} solve (backend={backend}) did not converge")
        best = min(best, res.solve_time)
    return best


def operator_path(mg, card, dev):
    """Phases 20-22: W and F cycles, periodic and segmented sides, and the
    line, ADI and Chebyshev smoothers at 1025^2; returns the kernel
    checks' errors."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp, smooth_var as ksv, \
        tail as kt, transfer as kx

    start = time.perf_counter()
    counted = {"smooth_multisweep": ks.multisweep,
               "residual_restrict": kx.residual_restrict,
               "prolong_correct": kx.prolong_correct,
               "tail_vcycle": kt.tail_vcycle}
    others = {"smooth_parity": ks.multisweep_parity,
              "smooth_var": ksv.multisweep_var,
              "residual_restrict_var": kx.residual_restrict_var,
              "tail_vcycle_var": kt.tail_vcycle_var,
              "smooth_planes": kp.multisweep_planes}
    every = {**counted, **others}
    prob, cfg = operator_config(mg, "W", "auto")
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    errs = kernel_phase_wf(mg, levels, cfg, dev)
    results = {}
    for name in OPERATOR_CASES:
        for w in every.values():
            w.launches = 0
        res = results[name] = operator_solve(mg, name, "auto", dev)
        got = {k: w.launches for k, w in every.items()}
        print(f"solve {name} auto launches {got}")
        if name in ("periodic", "segments", "segment_mms"):
            # phase 21: these levels pass no 2D kernel gate
            if any(got.values()):
                fail(f"{name}: 2D kernels launched on a periodic or "
                     f"segmented solve: {got}")
            if name == "periodic" and not (
                    torch.equal(res.u[-1], res.u[0])
                    and torch.equal(res.u[:, -1], res.u[:, 0])):
                fail("periodic solution: the duplicate nodes differ from "
                     "node 0")
            continue
        _, pcfg = operator_config(mg, name, "auto")
        plan = cycle_launches(levels, pcfg, res.iterations)
        print(f"solve {name}: launches {{A, B, C, D}} "
              f"{[got[k] for k in counted]}, planned "
              f"{[plan[k] for k in counted]}")
        if any(got[k] != plan[k] for k in counted) or any(
                got[k] for k in others):
            fail(f"{name}: launches {got} differ from the plan {plan}")
    for name in OPERATOR_CASES:
        res_p = operator_solve(mg, name, "torch", dev)
        u_k = results[name].u
        du = (u_k - res_p.u).abs().max().item()
        scale = res_p.u.abs().max().item()
        print(f"solve {name}: max|u_auto - u_torch| {du:.3e} (max|u| "
              f"{scale:.3e})")
        if res_p.iterations != results[name].iterations or \
                du > OPERATOR_PATH_RTOL * scale:
            fail(f"{name}: kernel and plain paths disagree (iterations "
                 f"{results[name].iterations} vs {res_p.iterations}, max "
                 f"diff {du:.3e} > {OPERATOR_PATH_RTOL} * {scale:.3e})")
    del results, levels
    torch.cuda.empty_cache()
    dofs = (N - 2) ** 2
    for name in OPERATOR_CASES:
        # the plain Chebyshev path is timed too (its transfers and coarsest
        # solve take kernels); W's and F's show in their checked solves
        for backend in ("auto", "torch") if name == "chebyshev" else (
                "auto",):
            t = timed_operator_solves(mg, name, backend, dev)
            print(f"solve time {name} {N}^2 {backend}: {t * 1e3:.3f} ms per "
                  f"solve, {dofs / t:.6e} DoF/s [{card}]")
    for name in ("W", "line_y", "periodic"):
        prob, pcfg = operator_config(mg, name, "auto")
        profile_solve(f"{name} ({prob.name}) {N}^2", lambda: mg.solve_poisson(
            prob, precision="fp32", cfg=pcfg, device=dev), counted,
            cpu=name == "W")
    print(f"phases 20-22: {time.perf_counter() - start:.1f} s")
    return errs


def kernel_phase_bf16(mg, card, dev):
    """Phase 23's kernel checks: A, B, C and D on bf16 storage against
    their twins (which widen, run the fp32 twin and round once), bit for
    bit, on data built from the seed, at the 1025^2 main path's shapes;
    CUDA-event ms (kernel and twin) of the record's calls, and device ms per
    call (torch.profiler) on bf16 beside the same call on fp32."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, tail as kt, transfer as kx

    bf = torch.bfloat16
    rng = np.random.default_rng(2323)

    def field(shape, scale=1.0, dtype=bf):
        a = np.zeros(shape, np.float32)
        a[1:-1, 1:-1] = scale * rng.standard_normal(
            (shape[0] - 2, shape[1] - 2))
        return torch.from_numpy(a).to(dev).to(dtype)

    def widened(fn):  # the difference is taken in fp32
        return lambda *a: fn(*a).float()

    fp32 = mg.build_hierarchy(mg.Grid(N, N), device=dev)
    bf16 = mg.build_hierarchy(mg.Grid(N, N), policy=mg.policy("bf16"),
                              device=dev)
    mixed = mg.build_hierarchy(mg.Grid(N, N), policy=mg.policy("mixed"),
                               device=dev)
    errs, times, dev_ms = {}, {}, {}
    sm = dict(method="rbgs", sweeps=2, omega=1.0)
    for lev, lev32 in zip(bf16[:3], fp32[:3]):
        n, st = lev.grid.nx, lev.stencil
        u, f = field((n, n)), field((n, n), st.c)
        compare("smooth_multisweep_bf16", f"{n}^2 bf16", widened(
            lambda a, b: ks.multisweep(st, a, b, **sm)), widened(
            lambda a, b: ks.multisweep_plain(st, a, b, **sm)),
            lambda: (u.clone(), f), errs, exact=True)
        u32, f32 = u.float(), f.float()
        # with the kernel named, a trace that lost A's launches is taken
        # again (one such trace read a quarter of the call)
        bf_ms = dev_ms[("smooth_multisweep_bf16", n)] = device_ms_per_call(
            lambda: ks.multisweep(st, u, f, **sm), 20, "smooth_kernel")
        fp32_ms = device_ms_per_call(
            lambda: ks.multisweep(lev32.stencil, u32, f32, **sm), 20,
            "smooth_kernel")
        print(f"A {n}^2 2-sweep RB-GS call: device {bf_ms:.4f} ms per call "
              f"on bf16, {fp32_ms:.4f} on fp32 [{card}]")
        if n == N:
            times[("smooth_multisweep_bf16", n)] = (
                time_ms(lambda: ks.multisweep(st, u, f, **sm)),
                time_ms(lambda: ks.multisweep_plain(st, u.clone(), f, **sm)))
    # u and f of two storages, at the 1025^2 and 257^2 levels and a field
    # narrower than a tile
    mixed_pairing_checks(
        "smooth_multisweep_bf16",
        [(lev.stencil, lev.grid.shape, lev.stencil.c)
         for lev in (fp32[0], fp32[2])]
        + [(stencil.make_stencil(mg.Grid(9, 61)), (9, 61), 1.0)],
        lambda st, a, b, **kw: ks.multisweep(st, a, b, layout="direct",
                                             **kw),
        ks.multisweep_plain, ks.multisweep, field, widened, errs,
        (("rbgs", 1.0), ("rbgs_rev", 1.0), ("jacobi", 0.8), ("sor", 1.3)))
    st, shape = bf16[-1].stencil, bf16[-1].grid.shape
    coarse = dict(method="rbgs", sweeps=32, omega=1.0)
    u, f = field(shape), field(shape, st.c)
    compare("smooth_multisweep_bf16", f"{shape[0]}^2 coarsest (32 sweeps, "
            f"{len(ks.plan_passes(32))} launches) bf16", widened(
            lambda a, b: ks.multisweep(st, a, b, **coarse)), widened(
            lambda a, b: ks.multisweep_plain(st, a, b, **coarse)),
            lambda: (u.clone(), f), errs, exact=True)

    st, nc = bf16[0].stencil, bf16[1].grid.nx
    u, f, ec = field((N, N)), field((N, N), st.c), field((nc, nc))
    compare("residual_restrict_bf16", f"{N}->{nc} bf16->bf16",
            widened(lambda a, b: kx.residual_restrict(st, a, b)),
            widened(lambda a, b: kx.residual_restrict_plain(st, a, b)),
            lambda: (u, f), errs, exact=True)
    u32, f32 = field((N, N), dtype=torch.float32), field(
        (N, N), st.c, torch.float32)
    compare("residual_restrict_bf16", f"{N}->{nc} fp32->bf16",
            widened(lambda a, b: kx.residual_restrict(st, a, b,
                                                      out_dtype=bf)),
            widened(lambda a, b: kx.residual_restrict_plain(st, a, b,
                                                            out_dtype=bf)),
            lambda: (u32, f32), errs, exact=True)
    compare("prolong_correct_bf16", f"{nc}->{N} bf16", widened(
        kx.prolong_correct), widened(kx.prolong_correct_plain),
        lambda: (ec, u.clone()), errs, exact=True)
    times[("residual_restrict_bf16", N)] = (
        time_ms(lambda: kx.residual_restrict(st, u, f)),
        time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
    times[("prolong_correct_bf16", N)] = (
        time_ms(lambda: kx.prolong_correct(ec, u)),
        time_ms(lambda: kx.prolong_correct_plain(ec, u.clone())))
    for lev, lev32 in zip(bf16[:3], fp32[:3]):
        n, st, nc = lev.grid.nx, lev.stencil, lev.grid.coarsen().nx
        u, f, ec = field((n, n)), field((n, n), st.c), field((nc, nc))
        u32, f32, ec32 = u.float(), f.float(), ec.float()
        for name, call, call32 in (
                ("residual_restrict_bf16",
                 lambda: kx.residual_restrict(st, u, f),
                 lambda: kx.residual_restrict(lev32.stencil, u32, f32)),
                ("prolong_correct_bf16", lambda: kx.prolong_correct(ec, u),
                 lambda: kx.prolong_correct(ec32, u32))):
            kernel = name[:-len("bf16")] + "kernel"
            bf_ms = dev_ms[(name, n)] = device_ms_per_call(call, 20, kernel)
            print(f"{name} {n}<->{nc}: device {bf_ms:.4f} ms per call on "
                  f"bf16, {device_ms_per_call(call32, 20, kernel):.4f} on "
                  f"fp32 [{card}]")

    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=False)
    for label, levels in (("bf16", bf16), ("mixed", mixed)):
        tail = [lev for lev in levels if lev.grid.nx <= TAIL_ENTRY]
        sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                       for lev in tail]
        dt = tail[0].dtype
        print(f"D {label} tail: " + ", ".join(
            f"{lev.grid.nx}^2 {lev.dtype}" for lev in tail))
        u0, f = field(shapes[0], dtype=dt), field(shapes[0], sts[0].c, dt)
        compare("tail_vcycle_bf16", f"{shapes[0][0]}^2 L={len(tail)} "
                f"{label} tail", widened(lambda a, b: kt.tail_vcycle(
                    sts, a, b, shapes=shapes, **kw)),
                widened(lambda a, b: kt.tail_vcycle_plain(
                    sts, a, b, shapes=shapes, **kw)),
                lambda: (u0.clone(), f), errs, exact=True)
        if label == "bf16":
            times[("tail_vcycle_bf16", TAIL_ENTRY)] = (
                time_ms(lambda: kt.tail_vcycle(sts, u0.clone(), f,
                                               shapes=shapes, **kw)),
                time_ms(lambda: kt.tail_vcycle_plain(
                    sts, u0.clone(), f, shapes=shapes, **kw)))
            dev_ms[("tail_vcycle_bf16", TAIL_ENTRY)] = device_ms(
                lambda: kt.tail_vcycle(sts, u0, f, shapes=shapes, **kw),
                "tail_vcycle", reps=20)
            sts32 = [lev.stencil for lev in fp32 if lev.grid.nx <= TAIL_ENTRY]
            u32, f32 = u0.float(), f.float()
            d32 = device_ms(lambda: kt.tail_vcycle(
                sts32, u32, f32, shapes=shapes, **kw), "tail_vcycle",
                reps=20)
            print(f"D from {TAIL_ENTRY}^2: device "
                  f"{dev_ms[('tail_vcycle_bf16', TAIL_ENTRY)]:.4f} ms per "
                  f"launch on a bf16 entry, {d32:.4f} on fp32 [{card}]")
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms")
    return errs, times, dev_ms


def mixed_pairing_checks(name, levels, kernel, twin, wrapper, field,
                         widened, errs, methods):
    """A, L or H on a u and an f of two storages (a bf16 u over an fp32 f,
    an fp32 u over a bf16 f) against its twin, bit for bit, at 1-5 sweeps
    (5: two launches) on each of ``levels`` ((fp32 stencil, shape, f's
    scale); H's planes in u's dtype): the output keeps u's dtype, one
    launch per pass."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks

    bf, fp = torch.bfloat16, torch.float32
    for st32, shape, scale in levels:
        for tu, tf in ((bf, fp), (fp, bf)):
            st = st32 if st32.scalar else st32.astype(tu)
            u, f = field(shape, dtype=tu), field(shape, scale, dtype=tf)
            for method, omega in methods:
                for sweeps in (1, 2, 3, 4, 5):
                    kw = dict(method=method, sweeps=sweeps, omega=omega)
                    before = wrapper.launches
                    out = kernel(st, u.clone(), f, **kw)
                    made = wrapper.launches - before
                    if out.dtype != tu or made != len(ks.plan_passes(sweeps)):
                        fail(f"{name} u {tu} f {tf} {kw}: {out.dtype} "
                             f"output in {made} launches")
                    compare(name, f"{shape[0]}x{shape[1]} u {str(tu)[6:]} "
                            f"f {str(tf)[6:]} {kw}",
                            widened(lambda a, b: kernel(st, a, b, **kw)),
                            widened(lambda a, b: twin(st, a, b, **kw)),
                            lambda: (u.clone(), f), errs, exact=True)


def check_solve(label, res, steps, slack, l2_ref, switches=None):
    """A phase 23-24 solve: finite, converged in ``steps`` +- ``slack``
    outer steps (or iterations), l2 within L2_RTOL of ``l2_ref``, and the
    form of its precision switches."""
    import torch

    info = res.info
    print(f"solve {label}: iterations {res.iterations} converged "
          f"{res.converged} l2 {res.errors['l2']:.6e} switches "
          f"{info.get('precision_switches')} solve "
          f"{res.solve_time * 1e3:.3f} ms (first call) history "
          f"{np.asarray(info['history']).tolist()}")
    if tuple(res.u.shape) != (N, N) or not torch.isfinite(res.u).all():
        fail(f"{label}: solution is misshapen or not finite")
    if not res.converged or abs(res.iterations - steps) > slack:
        fail(f"{label}: expected convergence in {steps} +- {slack} steps")
    if abs(res.errors["l2"] / l2_ref - 1) > L2_RTOL:
        fail(f"{label}: l2 error {res.errors['l2']:.4e} not within "
             f"{L2_RTOL:.0%} of {l2_ref:.4e}")
    got = [k for _, k in info.get("precision_switches", [])]
    if switches is not None and got != switches:
        fail(f"{label}: switches {info.get('precision_switches')} are not "
             f"of the form {switches}")


class _Solved:
    """adaptive_solve's result in solve_poisson's shape."""

    def __init__(self, u, info, prob, seconds):
        self.u, self.info, self.solve_time = u, info, seconds
        self.iterations, self.converged = info["iterations"], info["converged"]
        self.errors = prob.error_norms(u)


def precision_path(mg, card, dev):
    """Phase 23: precision staging on poisson_mms_sinsin(1025), tol 1e-9,
    RB-GS omega 1; returns the bf16 kernel checks' errors, times and device
    ms, and the bf16 launches of the bf16-start solve on the kernels."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import precision_analysis as pa
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp, smooth_var as ksv, \
        tail as kt, transfer as kx

    start = time.perf_counter()
    counted = {"smooth_multisweep": ks.multisweep,
               "residual_restrict": kx.residual_restrict,
               "prolong_correct": kx.prolong_correct,
               "tail_vcycle": kt.tail_vcycle}
    others = {"smooth_parity": ks.multisweep_parity,
              "smooth_var": ksv.multisweep_var,
              "residual_restrict_var": kx.residual_restrict_var,
              "tail_vcycle_var": kt.tail_vcycle_var,
              "smooth_planes": kp.multisweep_planes}

    def reset():
        for w in counted.values():
            w.launches = w.launches_bf16 = 0
        for w in others.values():
            w.launches = 0

    def read():
        return ({k: (w.launches, w.launches_bf16)
                 for k, w in counted.items()},
                {k: w.launches for k, w in others.items()})

    clocks("phase 23's device readings")
    errs, times, dev_ms = kernel_phase_bf16(mg, card, dev)
    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    for backend, slack in (("torch", 1), ("auto", 2)):
        reset()
        res = mg.solve_poisson(prob, precision="mixed",
                               cfg=cfg.replace(backend=backend), device=dev)
        got, rest = read()
        check_solve(f"mixed {N}^2 {backend}", res, PRECISION_REF["mixed"][0],
                    slack, PRECISION_REF["mixed"][1])
        print(f"solve mixed {backend} launches (all, bf16) {got}, others "
              f"{rest}")
        if backend == "auto":
            levels = mg.build_hierarchy(prob.grid, policy=mg.policy("mixed"),
                                        device=dev, cfg=cfg)
            plan = cycle_launches(levels, cfg, res.iterations)
            print(f"mixed auto: levels {[str(lev.dtype) for lev in levels]}; "
                  f"launches {{A, B, C, D}} {[got[k][0] for k in counted]}, "
                  f"planned {[plan[k] for k in counted]}")
            if any(got[k] != (plan[k], 0) for k in counted) or any(
                    rest.values()):
                fail(f"mixed auto: launches {got} {rest} differ from the "
                     f"plan {plan} (A-C on the fp32 levels above the tail, "
                     f"D once per V-cycle, none on bf16)")
    reset()
    res = mg.solve_poisson(prob, precision="adaptive",
                           cfg=cfg.replace(backend="auto"), device=dev)
    check_solve(f"adaptive {N}^2 auto", res, PRECISION_REF["adaptive"][0], 2,
                PRECISION_REF["adaptive"][1], switches=["ir"])
    print(f"solve adaptive auto launches (all, bf16) {read()[0]}")

    f64, u0 = prob.rhs(torch.float64, dev), prob.initial_guess(
        torch.float64, dev)
    bf16_launches = {}
    for backend in ("torch", "auto"):
        reset()
        t0 = time.perf_counter()
        u, info = mg.adaptive_solve(prob.grid, prob.spec, f64, u0,
                                    cfg=cfg.replace(backend=backend),
                                    start=mg.Precision.BF16, device=dev)
        torch.cuda.synchronize()
        res = _Solved(u, info, prob, time.perf_counter() - t0)
        got, rest = read()
        steps, l2 = PRECISION_REF["bf16_start"]
        if backend == "auto":
            # the kernels round once per call, the plain path after every
            # op: the kernel path is held to its twins' count (PERF.md,
            # phase 23)
            steps = BF16_START_TWINS[0]
            print(f"bf16 start auto: the twins' (iterations, switches) at "
                  f"{N}^2: {BF16_START_TWINS}")
        check_solve(f"adaptive bf16 start {N}^2 {backend}", res, steps, 3,
                    l2, switches=["fp32", "ir"])
        if info["precision_switches"][0] != (BF16_CHUNK, "fp32"):
            fail(f"bf16 start {backend}: the first switch is "
                 f"{info['precision_switches'][0]}, not (5, 'fp32')")
        print(f"solve bf16 start {backend} launches (all, bf16) {got}, "
              f"others {rest}")
        if backend == "auto":
            missing = [k for k in counted if got[k][1] <= 0]
            if missing:
                fail(f"bf16 start: no bf16 launch of {missing}")
            bf16_launches = {f"{k}_bf16": got[k][1] for k in counted}
    reset()
    recorded = []
    measure = pa.benchmark_function

    def recording(fn, *a, **k):
        stats = measure(fn, *a, **k)
        recorded.append(stats["min_s"])
        return stats

    pa.benchmark_function = recording
    try:
        # autotune measures once (runs=1); precision='auto' then takes its
        # cached choice (the cache key holds no run count)
        auto_cfg = cfg.replace(backend="auto")
        cands = ("fp32", "mixed", "adaptive")
        chosen = pa.autotune(prob, cfg=auto_cfg, candidates=cands, runs=1,
                             device=dev)
        print("autotune wall s per candidate (runs=1): " + ", ".join(
            f"{c} {t:.6f}" for c, t in zip(cands, recorded))
            + f"; chosen {chosen} [{card}]")
        if len(recorded) != len(cands):
            fail(f"autotune timed {len(recorded)} candidates, not "
                 f"{len(cands)}")
        res = mg.solve_poisson(prob, precision="auto", cfg=auto_cfg,
                               device=dev)
        if len(recorded) != len(cands) or not res.converged:
            fail("precision='auto' measured again, or did not converge")
        print(f"precision='auto': cache hit ({chosen}), {res.iterations} "
              f"iterations, l2 {res.errors['l2']:.6e}, "
              f"{res.solve_time * 1e3:.3f} ms")
    finally:
        pa.benchmark_function = measure
    times_ms = {}
    for label, run in (
            ("mixed", lambda: mg.solve_poisson(
                prob, precision="mixed", cfg=cfg.replace(backend="auto"),
                device=dev)),
            ("bf16_start", lambda: mg.adaptive_solve(
                prob.grid, prob.spec, f64, u0, cfg=cfg.replace(
                    backend="auto"), start=mg.Precision.BF16, device=dev)),
            ("fp32", lambda: mg.solve_poisson(
                prob, precision="fp32", cfg=cfg.replace(backend="auto"),
                device=dev))):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        times_ms[label] = best * 1e3
        print(f"solve time {label} {N}^2 auto: {best * 1e3:.3f} ms per solve "
              f"(set-up included, minimum of 3) [{card}]")
    profile_solve(f"mixed {N}^2", lambda: mg.solve_poisson(
        prob, precision="mixed", cfg=cfg.replace(backend="auto"),
        device=dev), counted)
    profile_solve(f"bf16-start adaptive {N}^2", lambda: mg.adaptive_solve(
        prob.grid, prob.spec, f64, u0, cfg=cfg.replace(backend="auto"),
        start=mg.Precision.BF16, device=dev), counted)
    print(f"phase 23: {time.perf_counter() - start:.1f} s")
    return errs, times, dev_ms, bf16_launches


def domain_path(mg, card, dev):
    """Phase 24: the corner and L-shaped problems at 1025^2 and the
    catalogue at 65^2."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_planes as kp, smooth_var as ksv, \
        tail as kt, transfer as kx

    start = time.perf_counter()
    counted = {"smooth_multisweep": ks.multisweep,
               "residual_restrict": kx.residual_restrict,
               "prolong_correct": kx.prolong_correct,
               "tail_vcycle": kt.tail_vcycle}
    every = {**counted, "smooth_parity": ks.multisweep_parity,
             "smooth_var": ksv.multisweep_var,
             "residual_restrict_var": kx.residual_restrict_var,
             "tail_vcycle_var": kt.tail_vcycle_var,
             "smooth_planes": kp.multisweep_planes}
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    for name in ("corner_singularity", "l_shaped"):
        prob = mg.CATALOGUE[name](N)
        steps, l2 = DOMAIN_REF[name]
        solved = {}
        for backend in ("auto", "torch"):
            for w in every.values():
                w.launches = 0
            res = solved[backend] = mg.solve_poisson(
                prob, precision="fp32", cfg=cfg.replace(backend=backend),
                device=dev)
            got = {k: w.launches for k, w in every.items()}
            check_solve(f"{name} {N}^2 {backend}", res, steps, 1, l2)
            print(f"solve {name} {backend} launches {got}")
            if backend == "torch":
                continue
            if name == "l_shaped":
                if any(got.values()):
                    fail(f"l_shaped: 2D kernels launched on a domain level: "
                         f"{got}")
                continue
            levels = mg.build_hierarchy(prob.grid, device=dev, cfg=cfg)
            plan = cycle_launches(levels, cfg, res.iterations)
            if any(got[k] != plan[k] for k in counted) or any(
                    got[k] for k in every if k not in counted):
                fail(f"{name}: launches {got} differ from the plan {plan}")
        du = (solved["auto"].u - solved["torch"].u).abs().max().item()
        print(f"solve {name}: max|u_auto - u_torch| {du:.3e}")
        if solved["auto"].iterations != solved["torch"].iterations:
            fail(f"{name}: the kernel and plain paths take "
                 f"{solved['auto'].iterations} and "
                 f"{solved['torch'].iterations} steps")
        best = float("inf")
        for _ in range(2):
            best = min(best, mg.solve_poisson(
                prob, precision="fp32", cfg=cfg.replace(backend="auto"),
                device=dev).solve_time)
        print(f"solve time {name} {N}^2 auto: {best * 1e3:.3f} ms per solve "
              f"(set-up included, minimum of 2) [{card}]")
        profile_solve(f"{name} {N}^2", lambda: mg.solve_poisson(
            prob, precision="fp32", cfg=cfg.replace(backend="auto"),
            device=dev), counted, cpu=False)
    for name, make in mg.CATALOGUE.items():
        prob = make(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    lam=prob.lam, domain=prob.domain,
                                    device=dev)
        f, u0 = prob.rhs(torch.float32, dev), prob.initial_guess(
            torch.float32, dev)
        if f.shape != (65, 65) or not (torch.isfinite(f).all()
                                       and torch.isfinite(u0).all()):
            fail(f"catalogue {name}: data misshapen or not finite")
        print(f"catalogue {name}: {prob.name}, {len(levels)} levels, "
              f"domain {prob.domain}")
    print(f"phase 24: {time.perf_counter() - start:.1f} s")


def all_wrappers():
    """Every launch-counting kernel wrapper, by the record's names."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth3d as ks3, smooth_planes as kp, \
        smooth_var as ksv, tail as kt, transfer as kx, transfer3d as kx3

    return {"smooth_multisweep": ks.multisweep,
            "residual_restrict": kx.residual_restrict,
            "prolong_correct": kx.prolong_correct,
            "tail_vcycle": kt.tail_vcycle,
            "smooth_var": ksv.multisweep_var,
            "residual_restrict_var": kx.residual_restrict_var,
            "tail_vcycle_var": kt.tail_vcycle_var,
            "smooth_parity": ks.multisweep_parity,
            "smooth_planes": kp.multisweep_planes,
            "rbgs3d": ks3.rbgs3d,
            "residual_restrict3d": kx3.residual_restrict3d,
            "prolong_correct3d": kx3.prolong_correct3d}


def counted_run(run):
    """``run()`` from every launch count reset to zero; returns its result
    and the counts just after it (synchronized)."""
    import torch

    every = all_wrappers()
    for w in every.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in every.items()}


def check_launches(label, got, plan):
    """Fail unless the counts equal ``plan`` (missing names: zero)."""
    want = {k: plan.get(k, 0) for k in got}
    print(f"{label}: launches {({k: v for k, v in got.items() if v})}, "
          f"plan {({k: v for k, v in want.items() if v})}")
    if got != want:
        fail(f"{label}: launches {got} differ from the plan {want}")


def best_ms(run, reps: int = 3) -> float:
    """Minimum wall ms of ``reps`` synchronized calls of ``run``."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def galerkin_path(mg, card, dev):
    """Phase 25: solve_poisson(precision='fp32') with Galerkin coarsening
    at 1025^2 on the jump and Poisson problems: the JAX reference's counts,
    the launch plans (level 0 alone takes a kernel: H on the jump
    problem, A on Poisson, two 2-sweep calls per V-cycle), 'auto' = 'torch',
    and the RAP chain built on the card against the CPU's."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv

    start = time.perf_counter()
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             coarsening="galerkin")
    for name, (steps, l2_ref) in GALERKIN_REF.items():
        prob = getattr(mg, name)(N)
        solved = {}
        for backend in ("auto", "torch"):
            res, got = counted_run(lambda: mg.solve_poisson(
                prob, precision="fp32", cfg=cfg.replace(backend=backend),
                device=dev))
            solved[backend] = res
            info = res.info
            rel = info["residual_norm"] / max(info["rhs_norm"],
                                              info["initial_residual_norm"])
            print(f"solve galerkin {name} {N}^2 {backend}: iterations "
                  f"{res.iterations} converged {res.converged} final "
                  f"relative residual {rel:.4e} errors {res.errors} history "
                  f"{info['history'].tolist()}")
            if tuple(res.u.shape) != (N, N) or not torch.isfinite(
                    res.u).all():
                fail(f"galerkin {name}: solution misshapen or not finite")
            if not res.converged or res.iterations != steps or rel > 1e-9:
                fail(f"galerkin {name} {backend}: expected convergence in "
                     f"{steps} outer steps below 1e-9 relative residual")
            if l2_ref is not None and abs(
                    res.errors["l2"] / l2_ref - 1) > L2_RTOL:
                fail(f"galerkin {name}: l2 {res.errors['l2']:.4e} not "
                     f"within {L2_RTOL:.0%} of {l2_ref:.4e}")
            cycles = res.iterations * IR_INNER_CYCLES
            if backend == "torch":
                check_launches(f"galerkin {name} torch", got, {})
            elif prob.a is None:
                check_launches(f"galerkin {name} auto", got, {
                    "smooth_multisweep": 2 * cycles * len(ks.plan_passes(2))})
            else:
                check_launches(f"galerkin {name} auto", got, {
                    "smooth_var": 2 * cycles * len(ksv.plan_passes(2))})
        du = (solved["auto"].u - solved["torch"].u).abs().max().item()
        scale = solved["torch"].u.abs().max().item()
        print(f"galerkin {name}: max|u_auto - u_torch| {du:.3e} (max|u| "
              f"{scale:.3e})")
        if du > OPERATOR_PATH_RTOL * scale:
            fail(f"galerkin {name}: kernel and plain paths differ by "
                 f"{du:.3e} > {OPERATOR_PATH_RTOL} * {scale:.3e}")

        def setup():
            return mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                      dtype="float32", device=dev, cfg=cfg)

        setup_ms = best_ms(setup)
        solve_ms = best_ms(lambda: mg.solve_poisson(
            prob, precision="fp32", cfg=cfg, device=dev))
        print(f"galerkin {name} {N}^2: set-up (build_hierarchy, the RAP "
              f"chain) {setup_ms:.3f} ms, solve_poisson {solve_ms:.3f} ms "
              f"per solve (set-up included), minimum of 3 [{card}]")
        profile_solve(f"galerkin {name} {N}^2", lambda: mg.solve_poisson(
            prob, precision="fp32", cfg=cfg, device=dev), all_wrappers(),
            cpu=False)
    # the RAP chain on the card against the same chain on the CPU (fp64)
    prob = mg.jump_coefficient_problem(N)
    chains = [mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                 dtype="float64", device=d, cfg=cfg)
              for d in (dev, "cpu")]
    worst = 0.0
    for lev_d, lev_c in zip(*chains):
        ref = [x.cpu() for x in lev_c.stencil.coefs] \
            if not lev_c.stencil.scalar else []
        got = [x.cpu() for x in lev_d.stencil.coefs] \
            if not lev_d.stencil.scalar else []
        scale = max((x.abs().max().item() for x in ref), default=1.0)
        for a, b in zip(got, ref):
            worst = max(worst, (a - b).abs().max().item() / scale)
    print(f"galerkin RAP chain at {N}^2, card against CPU: largest "
          f"difference {worst:.3e} of the level's largest coefficient")
    if worst > RAP_RTOL:
        fail(f"the card's RAP chain differs from the CPU's by {worst:.3e}")
    del chains
    torch.cuda.empty_cache()
    print(f"phase 25: {time.perf_counter() - start:.1f} s")


def mg_application_plan(levels, cfg):
    """A's, B's, C's and D's launches in one multigrid-preconditioner
    application under an fp64 Krylov vector: level 0 runs plain (its
    fields are fp64); each level below it down to the tail entry smooths
    through A twice and transfers through B and C once; the tail takes one
    D launch."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks

    plan = dict.fromkeys(("smooth_multisweep", "residual_restrict",
                          "prolong_correct", "tail_vcycle"), 0)
    for lev in levels[1:]:
        if lev.grid.nx <= TAIL_ENTRY:
            plan["tail_vcycle"] += 1
            break
        plan["smooth_multisweep"] += len(ks.plan_passes(
            cfg.pre_sweeps)) + len(ks.plan_passes(cfg.post_sweeps))
        plan["residual_restrict"] += 1
        plan["prolong_correct"] += 1
    return plan


def mg3d_application_plan(levels, cfg):
    """E's, F's and G's launches in one 3D multigrid-preconditioner
    application under an fp64 vector: none on level 0, E's planned passes
    for every smoothing call below it and one F and one G per transfer
    below it."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3

    *upper, coarsest = levels[1:]
    calls = [(lev.grid.shape, s) for lev in upper
             for s in (cfg.pre_sweeps, cfg.post_sweeps)]
    calls.append((coarsest.grid.shape, cfg.coarse_sweeps))
    return {"rbgs3d": sum(len(ks3.plan_passes(shape, s))
                          for shape, s in calls),
            "residual_restrict3d": len(upper),
            "prolong_correct3d": len(upper)}


def krylov_setup(mg, name, backend, dev):
    """(solver, matvec, b, precond, problem, levels, cfg) of one case of
    KRYLOV_REF."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import \
        preconditioning as pc
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        stencil as st_mod, stencil3d as st3
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import \
        krylov

    solver, kind, n, tol = KRYLOV_REF[name][:4]
    f64 = torch.float64
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, symmetric=True,
                             backend=backend)
    if kind == "mg3d":
        prob = mg.poisson3d_mms_sinsinsin(n)
        levels = mg.build_hierarchy3d(prob.grid, dtype="float32",
                                      device=dev, cfg=cfg)
        unk = levels[0].unknown
        mv = krylov.stencil_matvec3d(st3.make_stencil3d(prob.grid,
                                                        dtype=f64), unk)
        M = pc.multigrid_preconditioner3d(levels, cfg)
    else:
        prob = (mg.jump_coefficient_problem(n) if kind == "galerkin"
                else mg.poisson_mms_exponential(n))
        if kind == "galerkin":
            cfg = cfg.replace(coarsening="galerkin")
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    dtype="float32", device=dev, cfg=cfg)
        unk = levels[0].unknown
        st = st_mod.make_stencil(prob.grid, prob.spec, a=prob.a, dtype=f64,
                                 device=dev)
        mv = krylov.stencil_matvec(st, unk)
        M = {"mg": lambda: pc.multigrid_preconditioner(levels, cfg),
             "galerkin": lambda: pc.multigrid_preconditioner(levels, cfg),
             "diagonal": lambda: pc.diagonal(st, unk),
             "chebyshev": lambda: pc.chebyshev(st, unk, degree=4,
                                               grid=prob.grid),
             "block_line": lambda: pc.block_line(st, unk, axis=0)}[kind]()
    b = torch.where(unk, prob.rhs(f64, dev), 0.0)
    kw = dict(restart=30) if solver == "gmres" else {}

    def run():
        return getattr(krylov, solver)(mv, b, precond=M, tol=tol, **kw)

    return run, prob, levels, cfg


def krylov_path(mg, card, dev):
    """Phase 26: the Krylov solvers and their preconditioners; every case
    of KRYLOV_REF against the JAX reference's count (and l2), the launch
    plans of the multigrid preconditioner, 'auto' = 'torch' on MG-PCG, and
    ms per solve, device ops and busy share of MG-PCG, the Galerkin MG-PCG
    and the 3D MG-PCG."""
    import torch

    start = time.perf_counter()
    results = {}
    for name, (solver, kind, n, tol, steps, conv,
               l2_ref) in KRYLOV_REF.items():
        run, prob, levels, cfg = krylov_setup(mg, name, "auto", dev)
        (u, info), got = counted_run(run)
        results[name] = u
        l2 = None if prob.exact is None else prob.error_norms(u)["l2"]
        print(f"krylov {name} ({solver}, {kind}, tol {tol}) {n}: iterations "
              f"{info['iterations']} converged {info['converged']} "
              f"residual {info['residual_norm']:.6e} l2 {l2} history {info['history'][:12].tolist()}"
              f"{' ...' if len(info['history']) > 12 else ''}")
        if tuple(u.shape) != tuple(prob.grid.shape) or \
                not torch.isfinite(u).all():
            fail(f"krylov {name}: solution misshapen or not finite")
        if info["iterations"] != steps or info["converged"] != conv:
            fail(f"krylov {name}: {info['iterations']} iterations "
                 f"(converged {info['converged']}), the JAX reference "
                 f"{steps} ({conv})")
        if l2_ref is not None and abs(l2 / l2_ref - 1) > L2_RTOL:
            fail(f"krylov {name}: l2 {l2:.4e} not within {L2_RTOL:.0%} of "
                 f"{l2_ref:.4e}")
        applications = (info["iterations"] if solver == "gmres"
                        else info["iterations"] + 1)
        if kind == "mg":
            plan = {k: v * applications
                    for k, v in mg_application_plan(levels, cfg).items()}
        elif kind == "mg3d":
            plan = {k: v * applications
                    for k, v in mg3d_application_plan(levels, cfg).items()}
        else:
            plan = {}  # Stencil9 levels, fp64 level 0, or no multigrid
        check_launches(f"krylov {name}", got, plan)
        del levels
    run_p, *_ = krylov_setup(mg, "mg_pcg", "torch", dev)
    u_p, info_p = run_p()
    du = (results["mg_pcg"] - u_p).abs().max().item()
    scale = u_p.abs().max().item()
    print(f"krylov mg_pcg: max|u_auto - u_torch| {du:.3e} (max|u| "
          f"{scale:.3e}), torch iterations {info_p['iterations']}")
    if info_p["iterations"] != KRYLOV_REF["mg_pcg"][4] or \
            du > OPERATOR_PATH_RTOL * scale:
        fail(f"krylov mg_pcg: kernel and plain paths differ ({du:.3e})")
    del results, u_p
    torch.cuda.empty_cache()
    for name in ("mg_pcg", "galerkin_pcg", "mg3d_pcg"):
        run, prob, levels, cfg = krylov_setup(mg, name, "auto", dev)
        ms = best_ms(run)
        k = KRYLOV_REF[name][4]
        print(f"krylov {name} {KRYLOV_REF[name][2]}: {ms:.3f} ms per solve "
              f"({ms / k:.3f} ms per iteration, {k} iterations), minimum of "
              f"3, set-up excluded [{card}]")
        profile_solve(f"krylov {name}", run, all_wrappers(), cpu=False)
        del levels
        torch.cuda.empty_cache()
    print(f"phase 26: {time.perf_counter() - start:.1f} s")


def varcoef_heat(n):
    """a = 1 + x + y, u = sin(pi x) sin(pi y) e^{-t} on the unit square,
    all sides Dirichlet: q = u_t - div(a grad u) = e^{-t} [(2 pi^2 a - 1)
    sin sin - pi (cos(pi x) sin(pi y) + sin(pi x) cos(pi y))] (the same
    problem as scripts/heat_reference.py's)."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import Grid
    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat, heat_problems

    pi = np.pi

    def exact(X, Y, t):
        e = torch.exp(-t)
        return heat_problems._up(torch.sin(pi * X) * torch.sin(pi * Y), e) * e

    def q(X, Y, t):
        e = torch.exp(-t)
        s = ((2 * pi**2 * (1.0 + X + Y) - 1.0) * torch.sin(pi * X)
             * torch.sin(pi * Y)
             - pi * (torch.cos(pi * X) * torch.sin(pi * Y)
                     + torch.sin(pi * X) * torch.cos(pi * Y)))
        return heat_problems._up(s, e) * e

    return heat.heat_problem_from_callables(
        "heat_varcoef", Grid(n, n), exact=exact, q=q,
        a=lambda X, Y: 1.0 + X + Y)


def heat_setup(mg, key, backend):
    """(problem, t_final, dt, n_steps, HeatConfig) of HEAT_RUNS[key]."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat, heat_problems

    name, n, scheme, dtype, t_final, dt, n_steps, extra = HEAT_RUNS[key]
    prob = (varcoef_heat(n) if name == "varcoef"
            else heat_problems.CATALOGUE[name](n))
    if scheme == "explicit":
        t_final = 10 * 0.9 * heat.stability_limit_dt(prob.grid, prob.alpha)
    cfg = heat.HeatConfig(scheme=scheme, dtype=dtype, mg=mg.MultigridConfig(
        smoother="rbgs", omega=1.0, backend=backend), **extra)
    return prob, t_final, dt, n_steps, cfg


def counted_cycles(run, module, name):
    """``run()`` with ``module.name`` (a cycle function) counting its
    calls; returns (result, calls)."""
    real, calls = getattr(module, name), [0]

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    setattr(module, name, counting)
    try:
        return run(), calls[0]
    finally:
        setattr(module, name, real)


def heat_cycle_plan(levels, cfg):
    """The kernel launches of one shifted V-cycle over 2D heat levels, from
    dispatch's gates: an all-Dirichlet level above the tail entry smooths
    twice through A (constant coefficients) or H (coefficient planes),
    restricts through B or I and prolongs through C; the tail from
    TAIL_ENTRY is one D or J launch. A level with Neumann sides smooths
    plain and takes no tail: I and C on every level above the coarsest."""
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv

    scalar = levels[0].stencil.scalar
    dirichlet = levels[0].spec.all_dirichlet
    passes = ks if scalar else ksv
    plan = {}

    def add(name, k=1):
        plan[name] = plan.get(name, 0) + k

    for lev in levels[:-1]:
        if dirichlet and lev.grid.nx <= TAIL_ENTRY:
            add("tail_vcycle" if scalar else "tail_vcycle_var")
            return plan
        if dirichlet:
            add("smooth_multisweep" if scalar else "smooth_var",
                len(passes.plan_passes(cfg.pre_sweeps))
                + len(passes.plan_passes(cfg.post_sweeps)))
        add("residual_restrict" if scalar else "residual_restrict_var")
        add("prolong_correct")
    return plan


def heat_kernel_checks(mg, dev):
    """A, B, C and D on the shifted hierarchy of a 1025^2 CN step (lam =
    1/(0.5 dt) in fp32), H, I, C and J on the shifted levels of the
    varcoef run, I and C on those of neumann_heat, and E, F and G on a
    shifted 513^3 level, against their twins (seeded inputs on the card).
    H, I, J, C and E-G are held bit for bit, as on unshifted stencils; A-D
    to KERNEL_RTOL, each reported."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat, heat3d, heat_problems
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth3d as ks3, smooth_var as ksv, \
        tail as kt, transfer as kx, transfer3d as kx3

    gen = torch.Generator(device=dev).manual_seed(1357)

    def field(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    lam = heat.theta_shift(1.0, 0.5, 1e-4, torch.float32)
    print(f"heat shift lam = 1/(0.5 * 1e-4) in fp32: {lam.item()!r}")
    errs = {}
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0)
    sm = dict(method="rbgs", sweeps=cfg.pre_sweeps, omega=cfg.omega)
    tail_kw = dict(pre=cfg.pre_sweeps, post=cfg.post_sweeps, omega=cfg.omega,
                   method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
                   symmetric=cfg.symmetric)

    def check(name, label, kernel, plain, inputs, exact):
        one = {}
        compare(name, f"shifted {label}", kernel, plain, inputs, one,
                exact=exact)
        print(f"  {name} shifted {label}: "
              f"{'bit for bit' if one[name] == 0 else 'NOT bit for bit'}")
        errs[name] = max(errs.get(name, 0.0), one[name])

    hier = {
        "pure_diffusion": mg.build_hierarchy(mg.Grid(N, N), device=dev,
                                             cfg=cfg),
        "varcoef": mg.build_hierarchy(
            mg.Grid(N, N), a=varcoef_heat(N).a, device=dev, cfg=cfg),
        "neumann": mg.build_hierarchy(
            mg.Grid(N, N), heat_problems.neumann_heat(3).spec, device=dev,
            cfg=cfg)}
    for name, levels in hier.items():
        levels = heat.shift_hierarchy(levels, lam)
        sides = levels[0].spec.dirichlet_sides
        for lev in levels[:3]:
            n, st, nc = lev.grid.nx, lev.stencil, (lev.grid.nx - 1) // 2 + 1
            u, f = field((n, n)), field((n, n), 1e3)
            ec = field((nc, nc))
            if name == "pure_diffusion":
                check("smooth_multisweep", f"{n}^2",
                      lambda a, b: ks.multisweep(st, a, b, **sm),
                      lambda a, b: ks.multisweep_plain(st, a, b, **sm),
                      lambda: (u.clone(), f), False)
                check("residual_restrict", f"{n}->{nc}",
                      lambda a, b: kx.residual_restrict(st, a, b),
                      lambda a, b: kx.residual_restrict_plain(st, a, b),
                      lambda: (u, f), False)
            else:
                if name == "varcoef":
                    check("smooth_var", f"varcoef {n}^2",
                          lambda a, b: ksv.multisweep_var(st, a, b, **sm),
                          lambda a, b: ks.multisweep_plain(st, a, b, **sm),
                          lambda: (u.clone(), f), True)
                check("residual_restrict_var", f"{name} {n}->{nc}",
                      lambda a, b: kx.residual_restrict_var(st, a, b,
                                                            sides=sides),
                      lambda a, b: kx.residual_restrict_plain(st, a, b,
                                                              sides=sides),
                      lambda: (u, f), True)
            check("prolong_correct", f"{name} {nc}->{n}",
                  lambda a, b: kx.prolong_correct(a, b, sides=sides),
                  lambda a, b: kx.prolong_correct_plain(a, b, sides=sides),
                  lambda: (ec, u.clone()), name != "pure_diffusion")
        if name != "pure_diffusion":  # I at every level size, offsets
            for lev in levels[:-1]:
                n, nc = lev.grid.nx, (lev.grid.nx - 1) // 2 + 1
                i_offset_checks(kx, lev.stencil, field((n, n)),
                                field((n, n), 1e3), f"shifted {name} "
                                f"{n}->{nc}", errs, sides=sides)
        if name != "neumann":
            tail = [lev for lev in levels if lev.grid.nx <= TAIL_ENTRY]
            sts = [lev.stencil for lev in tail]
            shapes = [lev.grid.shape for lev in tail]
            f = field(shapes[0], 1e3)
            u0 = torch.zeros(shapes[0], device=dev)
            kernel = kt.tail_vcycle if name == "pure_diffusion" \
                else kt.tail_vcycle_var
            check("tail_vcycle" if name == "pure_diffusion"
                  else "tail_vcycle_var", f"{name} {TAIL_ENTRY}^2",
                  lambda a, b: kernel(sts, a, b, shapes=shapes, **tail_kw),
                  lambda a, b: kt.tail_vcycle_plain(sts, a, b, shapes=shapes,
                                                    **tail_kw),
                  lambda: (u0.clone(), f), name != "pure_diffusion")
    del hier
    levels3 = heat3d.shift_hierarchy3d(mg.build_hierarchy3d(
        mg.Grid3D(N3, N3, N3), dtype="float32", device=dev, cfg=cfg)[:2],
        lam)
    st = levels3[0].stencil
    u, f = torch.zeros((N3,) * 3, device=dev), field((N3,) * 3, 1e3)
    u[1:-1, 1:-1, 1:-1] = field((N3 - 2,) * 3)  # a zero Dirichlet shell
    nc = levels3[1].grid.nx
    check("rbgs3d", f"{N3}^3",
          lambda a, b: ks3.rbgs3d(st, a, b, sweeps=2),
          lambda a, b: ks3.rbgs3d_plain(st, a, b, sweeps=2),
          lambda: (u.clone(), f), True)
    check("residual_restrict3d", f"{N3}->{nc}",
          lambda a, b: kx3.residual_restrict3d(st, a, b),
          lambda a, b: kx3.residual_restrict3d_plain(st, a, b),
          lambda: (u, f), True)
    ec = field((nc,) * 3)
    check("prolong_correct3d", f"{nc}->{N3}", kx3.prolong_correct3d,
          kx3.prolong_correct3d_plain, lambda: (ec, u.clone()), True)
    del u, f, ec
    torch.cuda.empty_cache()
    return errs


def heat_path(mg, card, dev):
    """Phase 27: the 2D heat equations at 1025^2 (HEAT_RUNS): each run's
    launches per cycle and cycles per step; fp64 runs against the JAX
    package's steps and l2, fp32 runs against their l2 bound and the plain
    path on the card; a checkpoint resume; ms per step and a profile of one
    CN step."""
    import shutil as _shutil

    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import \
        multigrid

    start = time.perf_counter()
    solved = {}
    for key, (name, n, scheme, dtype, *_) in HEAT_RUNS.items():
        prob, t_final, dt, n_steps, cfg = heat_setup(mg, key, "auto")
        (res, got), cycles = counted_cycles(lambda: counted_run(
            lambda: mg.solve_heat(prob, t_final, dt, cfg, n_steps=n_steps,
                                  device=dev)), multigrid, "mg_cycle")
        solved[key] = res
        print(f"heat {key}: {name} {n}^2 {scheme} {dtype}: steps "
              f"{res.steps} t {res.t:.6g} errors {res.errors} cycles "
              f"{cycles}")
        if tuple(res.u.shape) != (n, n) or not torch.isfinite(res.u).all():
            fail(f"heat {key}: state misshapen or not finite")
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    device=dev, cfg=cfg.mg)
        implicit = 0 if scheme == "explicit" else res.steps
        if dtype == "float32" and implicit:
            per_cycle = heat_cycle_plan(levels, cfg.mg)
            check_launches(f"heat {key}", got,
                           {k: v * cycles for k, v in per_cycle.items()})
            if "tail_vcycle" in per_cycle and cycles != \
                    HEAT_CYCLES_FP32 * implicit:
                fail(f"heat {key}: {cycles} cycles in {implicit} fp32 "
                     f"steps, not {HEAT_CYCLES_FP32} per step")
        else:
            check_launches(f"heat {key}", got, {})  # fp64, explicit
        del levels
        if key in HEAT_REF:
            steps, l2_ref = HEAT_REF[key]
            if res.steps != steps or abs(
                    res.errors["l2"] / l2_ref - 1) > L2_RTOL:
                fail(f"heat {key}: {res.steps} steps, l2 "
                     f"{res.errors['l2']:.6e}; the JAX reference {steps}, "
                     f"{l2_ref:.6e} (+-{L2_RTOL:.0%})")
            if key == "adaptive_fp64":
                print(f"heat {key}: dt_history {res.dt_history.tolist()}")
            continue
        if res.errors["l2"] > HEAT_L2_BOUND[key]:
            fail(f"heat {key}: l2 {res.errors['l2']:.6e} above its bound "
                 f"{HEAT_L2_BOUND[key]:.6e}")
        prob_p, *_, cfg_p = heat_setup(mg, key, "torch")
        t0 = time.perf_counter()
        res_p, got_p = counted_run(lambda: mg.solve_heat(
            prob_p, t_final, dt, cfg_p, n_steps=n_steps, device=dev))
        plain_s = time.perf_counter() - t0
        check_launches(f"heat {key} torch", got_p, {})
        du = (res.u - res_p.u).abs().max().item()
        scale = res_p.u.abs().max().item()
        exact = key in ("neumann", "varcoef", "explicit")
        print(f"heat {key}: max|u_auto - u_torch| {du:.3e} (max|u| "
              f"{scale:.3e}; {'bit for bit' if du == 0 else 'not bit for bit'}"
              f"); torch l2 {res_p.errors['l2']:.6e}, first call "
              f"{plain_s * 1e3:.1f} ms")
        if (exact and du != 0) or du > HEAT_PATH_RTOL * scale:
            fail(f"heat {key}: kernel and plain paths differ by {du:.3e}")
        del res_p, prob_p
    # a checkpoint resume on the card: 5 steps, then 5 more, against the
    # uninterrupted CN run
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "heat_checkpoint")
    _shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        prob, t_final, dt, _, cfg = heat_setup(mg, "cn", "auto")
        ck = mg.CheckpointManager(ck_dir)
        mg.solve_heat(prob, t_final / 2, dt, cfg, checkpoint=ck,
                      checkpoint_every=5, device=dev)
        res = mg.solve_heat(prob, t_final, dt, cfg, checkpoint=ck,
                            checkpoint_every=5, device=dev)
        same = torch.equal(res.u, solved["cn"].u)
        print(f"heat checkpoint resume (5 + 5 CN steps): latest step "
              f"{ck.latest_step()}, equal to the uninterrupted run bit for "
              f"bit: {same}")
        if not same or ck.latest_step() != 10:
            fail("heat: the resumed run differs from the uninterrupted one")
    finally:
        _shutil.rmtree(ck_dir, ignore_errors=True)
    # ms per step, and one CN step profiled
    for key in ("cn", "bdf2", "varcoef"):
        prob, t_final, dt, n_steps, cfg = heat_setup(mg, key, "auto")
        steps = solved[key].steps
        ms = best_ms(lambda: mg.solve_heat(prob, t_final, dt, cfg,
                                           n_steps=n_steps, device=dev))
        print(f"heat {key} {N}^2: {ms / steps:.3f} ms per step ({ms:.3f} ms "
              f"per {steps}-step run, minimum of 3, initial state and error "
              f"norms included) [{card}]")
    prob, t_final, dt, _, cfg = heat_setup(mg, "cn", "auto")
    levels = mg.build_hierarchy(prob.grid, device=dev, cfg=cfg.mg)
    step = heat.make_step_fn(prob, levels, cfg)
    u = prob.initial_state(torch.float32, dev)
    profile_solve(f"heat CN step {N}^2", lambda: step(u, u, 0.0, dt),
                  all_wrappers())
    del solved, levels, u, step
    torch.cuda.empty_cache()
    print(f"phase 27: {time.perf_counter() - start:.1f} s")


def heat3d_path(mg, card, dev):
    """Phase 28: solve_heat3d on oscillating3d in fp32 (HEAT3D_RUNS): E, F
    and G make their planned launches per cycle, l2 within its bound, the
    plain path on the card bit for bit; ms per step, busy share of one
    step, peak memory."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat, heat3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3
    from mixed_precision_multigrid_solvers_for_pdes_torch.solvers import \
        multigrid3d

    start = time.perf_counter()
    for key, (n, scheme, t_final, dt) in HEAT3D_RUNS.items():
        def run(backend, **kw):
            cfg = heat.HeatConfig(scheme=scheme, mg=mg.MultigridConfig(
                smoother="rbgs", omega=1.0, backend=backend), **kw)
            return mg.solve_heat3d(heat3d.oscillating3d(n), t_final, dt,
                                   cfg, device=dev)

        torch.cuda.reset_peak_memory_stats(dev)
        (res, got), cycles = counted_cycles(lambda: counted_run(
            lambda: run("auto")), multigrid3d, "mg_cycle3d")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"heat3d {key}: oscillating3d {n}^3 {scheme} fp32: steps "
              f"{res['steps']} t {res['t']:.6g} errors {res['errors']} "
              f"cycles {cycles}; peak memory {peak / 2**30:.3f} GiB")
        if tuple(res["u"].shape) != (n,) * 3 or \
                not torch.isfinite(res["u"]).all():
            fail(f"heat3d {key}: state misshapen or not finite")
        e_cycle, transfers = launches_per_cycle(mg, ks3, n, dev)
        if cycles != 2 * res["steps"]:
            fail(f"heat3d {key}: {cycles} cycles in {res['steps']} steps")
        check_launches(f"heat3d {key}", got, {
            "rbgs3d": e_cycle * cycles,
            "residual_restrict3d": transfers * cycles,
            "prolong_correct3d": transfers * cycles})
        if res["errors"]["l2"] > HEAT3D_L2_BOUND[key]:
            fail(f"heat3d {key}: l2 {res['errors']['l2']:.6e} above its "
                 f"bound {HEAT3D_L2_BOUND[key]:.6e}")
        u_k = res["u"]
        del res
        t0 = time.perf_counter()
        res_p = run("torch")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        du = (u_k - res_p["u"]).abs().max().item()
        print(f"heat3d {key}: max|u_auto - u_torch| {du:.3e} (plain "
              f"{plain_s * 1e3:.1f} ms per {res_p['steps']}-step run, first "
              "call)")
        if du != 0:
            fail(f"heat3d {key}: kernel and plain paths differ ({du:.3e})")
        del res_p, u_k
        torch.cuda.empty_cache()
        if key == "cn":
            # where the fp32 error comes from: fp64 (plain) and 8 cycles
            for label, backend, kw in (("fp64", "torch",
                                        dict(dtype="float64")),
                                       ("fp32, 8 cycles", "auto",
                                        dict(cycles_per_step=8))):
                err = run(backend, **kw)["errors"]["l2"]
                print(f"heat3d {key} {n}^3 {label}: l2 {err:.6e}")
                torch.cuda.empty_cache()
        ms = best_ms(lambda: run("auto"), reps=2)
        steps = round(t_final / dt)
        print(f"heat3d {key} {n}^3: {ms / steps:.3f} ms per step ({ms:.3f} "
              f"ms per {steps}-step run, set-up included, minimum of 2) "
              f"[{card}]")
        torch.cuda.empty_cache()
    # one CN step at 513^3 profiled, through the solver's own step: a
    # one-step run (set-up, initial state and error norms included)
    n, scheme, _, dt = HEAT3D_RUNS["cn"]
    cfg = heat.HeatConfig(mg=mg.MultigridConfig(smoother="rbgs", omega=1.0))
    profile_solve(f"heat3d CN one-step run {n}^3", lambda: mg.solve_heat3d(
        heat3d.oscillating3d(n), dt, dt, cfg, device=dev), all_wrappers())
    torch.cuda.empty_cache()
    print(f"phase 28: {time.perf_counter() - start:.1f} s")


def kernel_phase3d_bf16(mg, card, dev):
    """Phase 29: E, F and G on bf16 storage against their twins (which
    widen, run the fp32 twin and round once), bit for bit, at the levels and
    dtype combinations of the 513^3 'mixed' and 'bf16' hierarchies, on data
    from a seeded generator on the card; CUDA-event ms (kernel and twin) of
    the record's calls at 513^3, and device ms per launch (torch.profiler)
    on bf16 beside the same call on fp32, with the 2-byte bound."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3, transfer3d as kx3

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2929)

    def field(shape, scale=1.0, dtype=bf, shell=False):
        a = scale * torch.randn(shape, generator=gen, device=dev)
        if not shell:
            inner = a[1:-1, 1:-1, 1:-1].clone()
            a.zero_()
            a[1:-1, 1:-1, 1:-1] = inner
        return a.to(dtype)

    def widened(fn):  # the difference is taken in fp32
        return lambda *a: fn(*a).float()

    g = mg.Grid3D(N3, N3, N3)
    fp32 = mg.build_hierarchy3d(g, device=dev)
    bf16 = mg.build_hierarchy3d(g, policy=mg.policy("bf16"), device=dev)
    mixed = mg.build_hierarchy3d(g, policy=mg.policy("mixed"), device=dev)
    print("phase 29: mixed levels " + ", ".join(
        f"{lev.grid.nx}^3 {str(lev.dtype).split('.')[-1]}" for lev in mixed))
    errs, times, dev_ms = {}, {}, {}
    # E: the bf16 levels of both hierarchies (the coarsest's 32 sweeps in
    # one launch), 3 sweeps (an fp32 pass, then a bf16 one) at 257^3
    for lev in [bf16[0], bf16[1]] + [m for m in mixed if m.dtype == bf]:
        n, st = lev.grid.nx, lev.stencil
        u, f = field((n,) * 3), field((n,) * 3, st.c)
        cases = [(2, 1.0, False)]
        if n == N3:
            cases += [(2, 1.0, True), (1, 1.3, False)]
        if n == N3_REF:
            cases.append((3, 1.3, True))
        if n == 3:
            cases = [(32, 1.0, False)]
        for sweeps, omega, reverse in cases:
            kw = dict(sweeps=sweeps, omega=omega, reverse=reverse)
            compare("rbgs3d_bf16", f"{n}^3 bf16 {kw} "
                    f"({len(ks3.plan_passes(u.shape, sweeps))} launches)",
                    widened(lambda a, b: ks3.rbgs3d(st, a, b, **kw)),
                    widened(lambda a, b: ks3.rbgs3d_plain(st, a, b, **kw)),
                    lambda: (u.clone(), f), errs, exact=True)
        if n == N3:
            times[("rbgs3d_bf16", n)] = (
                time_ms(lambda: ks3.rbgs3d(st, u, f), reps=10),
                time_ms(lambda: ks3.rbgs3d_plain(st, u.clone(), f), reps=3))
            u32, f32 = u.float(), f.float()
            st32 = fp32[0].stencil
            e_bf = dev_ms[("rbgs3d_bf16", n)] = device_ms(
                lambda: ks3.rbgs3d(st, u, f), "rbgs3d")
            e_32 = device_ms(lambda: ks3.rbgs3d(st32, u32, f32), "rbgs3d")
            print(f"E {n}^3 2-sweep call: device {e_bf:.4f} ms per launch "
                  f"on bf16, {e_32:.4f} on fp32; bound "
                  f"{bound('rbgs3d_bf16')[0]:.4f} ms (2 bytes a node) and "
                  f"{bound('rbgs3d')[0]:.4f} (4 bytes) [{card}]")
            del u32, f32
        del u, f
    torch.cuda.empty_cache()
    # F and G: uniform bf16 at 513 <-> 257, the mixed crossing 65 <-> 33
    # (fp32 fine level, bf16 coarse), and all-bf16 33 <-> 17
    cross = [i for i, m in enumerate(mixed) if m.dtype == bf][0] - 1
    for label, fine, coarse in (("bf16", bf16[0], bf16[1]),
                                ("mixed", mixed[cross], mixed[cross + 1]),
                                ("mixed", mixed[cross + 1],
                                 mixed[cross + 2])):
        n, nc, st = fine.grid.nx, coarse.grid.nx, fine.stencil
        u = field((n,) * 3, dtype=fine.dtype)
        f = field((n,) * 3, st.c, dtype=fine.dtype)
        ec = field((nc,) * 3, dtype=coarse.dtype, shell=True)
        kinds = f"{str(fine.dtype)[6:]}->{str(coarse.dtype)[6:]}"
        compare("residual_restrict3d_bf16", f"{n}->{nc} {label} {kinds}",
                widened(lambda a, b: kx3.residual_restrict3d(
                    st, a, b, out_dtype=coarse.dtype)),
                widened(lambda a, b: kx3.residual_restrict3d_plain(
                    st, a, b, out_dtype=coarse.dtype)),
                lambda: (u, f), errs, exact=True)
        compare("prolong_correct3d_bf16", f"{nc}->{n} {label} ec "
                f"{str(coarse.dtype)[6:]}, u {str(fine.dtype)[6:]}",
                widened(kx3.prolong_correct3d),
                widened(kx3.prolong_correct3d_plain),
                lambda: (ec, u.clone()), errs, exact=True)
        if n == N3:
            times[("residual_restrict3d_bf16", n)] = (
                time_ms(lambda: kx3.residual_restrict3d(st, u, f), reps=10),
                time_ms(lambda: kx3.residual_restrict3d_plain(st, u, f),
                        reps=3))
            times[("prolong_correct3d_bf16", n)] = (
                time_ms(lambda: kx3.prolong_correct3d(ec, u), reps=10),
                time_ms(lambda: kx3.prolong_correct3d_plain(ec, u.clone()),
                        reps=3))
            u32, f32, ec32 = u.float(), f.float(), ec.float()
            st32 = fp32[0].stencil
            for name, call, call32 in (
                    ("residual_restrict3d",
                     lambda: kx3.residual_restrict3d(st, u, f),
                     lambda: kx3.residual_restrict3d(st32, u32, f32)),
                    ("prolong_correct3d", lambda: kx3.prolong_correct3d(ec, u),
                     lambda: kx3.prolong_correct3d(ec32, u32))):
                d_bf = dev_ms[(f"{name}_bf16", n)] = device_ms(call, name)
                d_32 = device_ms(call32, name)
                print(f"{name} {n}<->{nc}: device {d_bf:.4f} ms per launch "
                      f"on bf16, {d_32:.4f} on fp32; bound "
                      f"{bound(name + '_bf16')[0]:.4f} ms (2 bytes a node) "
                      f"and {bound(name)[0]:.4f} (4 bytes) [{card}]")
            del u32, f32, ec32
        del u, f, ec
        torch.cuda.empty_cache()
    word_pair_checks(ks3, kx3, field, widened, errs, dev)
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^3: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"[{card}]")
    return errs, times, dev_ms


def word_pair_checks(ks3, kx3, field, widened, errs, dev):
    """Phase 29: E's bf16 planes come in as pairs of 4-byte words, F's as
    16-byte chunks, each row's shift read from the element address. E at
    nz even and odd and at 513^3, F at (37, 69, 131) and 513 -> 257, with u
    and f views at odd storage offsets (a field that starts in a word's
    upper half), E's multi-launch storages, an fp32 u with a bf16 f and a
    bf16 u with an fp32 f (1-3 sweeps, one-block and wave-sized fields),
    F's crossings: against their twins bit for bit."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch import Grid3D
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        stencil3d

    bf = torch.bfloat16

    for shape in E_PAIR_SHAPES + ((N3,) * 3,):
        st = stencil3d.make_stencil3d(Grid3D(*shape))
        u, f = field(shape, shell=True), field(shape, st.c)
        cases = [(1, 0, 2, bf), (0, 1, 2, bf), (1, 1, 5, bf),
                 (0, 1, 2, torch.float32)]
        for ou, of, sweeps, ud in cases:
            if shape[0] == N3 and sweeps != 2:
                continue
            kw = dict(sweeps=sweeps, omega=1.3)
            compare("rbgs3d_bf16", f"{shape} u {str(ud)[6:]} at offset "
                    f"{ou}, f at {of}, {sweeps} sweeps",
                    widened(lambda a, b: ks3.rbgs3d(st, a, b, **kw)),
                    widened(lambda a, b: ks3.rbgs3d_plain(st, a, b, **kw)),
                    lambda: (at_offset(u.to(ud), ou), at_offset(f, of)),
                    errs, exact=True)
        del u, f
    # E with a bf16 u over an fp32 f and an fp32 u over a bf16 f at 1-3
    # sweeps, on a one-block field and wave-sized ones (storages 5, 1 and
    # 4; 2 at every sweep count), u at an odd offset
    f32 = torch.float32
    for shape in ((9, 10, 11),) + E_PAIR_SHAPES:
        st = stencil3d.make_stencil3d(Grid3D(*shape))
        u = field(shape, shell=True, dtype=f32)
        f = field(shape, st.c, dtype=f32)
        for ud, fd in ((bf, f32), (f32, bf)):
            for sweeps in (1, 2, 3):
                kw = dict(sweeps=sweeps, omega=1.3)
                compare("rbgs3d_bf16", f"{shape} u {str(ud)[6:]} at offset "
                        f"1, f {str(fd)[6:]}, {sweeps} sweeps "
                        f"({len(ks3.plan_passes(shape, sweeps))} launches)",
                        widened(lambda a, b: ks3.rbgs3d(st, a, b, **kw)),
                        widened(lambda a, b: ks3.rbgs3d_plain(st, a, b,
                                                              **kw)),
                        lambda: (at_offset(u.to(ud), 1), f.to(fd)), errs,
                        exact=True)
        del u, f
    for shape in F_PAIR_SHAPES + ((N3,) * 3,):
        st = stencil3d.make_stencil3d(Grid3D(*shape))
        u, f = field(shape, shell=True), field(shape, st.c)
        for off in (0, 1):
            for tin, tout in ((bf, bf), (bf, torch.float32),
                              (torch.float32, bf)):
                if tin != bf and off:
                    continue
                compare("residual_restrict3d_bf16",
                        f"{shape} {str(tin)[6:]} -> {str(tout)[6:]}, u at "
                        f"offset {off}, f at {1 - off}",
                        widened(lambda a, b: kx3.residual_restrict3d(
                            st, a, b, out_dtype=tout)),
                        widened(lambda a, b: kx3.residual_restrict3d_plain(
                            st, a, b, out_dtype=tout)),
                        lambda: (at_offset(u.to(tin), off),
                                 at_offset(f.to(tin), 1 - off)),
                        errs, exact=True)
        del u, f
    torch.cuda.empty_cache()


def cycle_visits3d(num_levels, cfg):
    """How often one 3D cycle of ``cfg`` visits each level, as
    solvers/multigrid3d._cycle3 recurses: a 'W' level below w_depth visits
    its coarse level twice, 'V' and 'F' once (the JAX package's 3D F-cycle
    is a V-cycle)."""
    visits, kind = [1], cfg.cycle
    for lvl in range(num_levels - 1):
        branch = kind if lvl + 1 < cfg.w_depth else "V"
        visits.append(visits[-1] * (2 if kind == "W" and branch == "W"
                                    else 1))
        kind = branch
    return visits


def cycle_plan3d(levels, cfg, cycles, ks3, smooth=True):
    """E, F and G launches (all, bf16) of ``cycles`` cycles over
    ``levels`` of scalar 7-point all-Dirichlet levels: E plans its passes
    per smoothing call (none when ``smooth`` is False, a smoother E does
    not run, but the coarsest RB-GS), F and G one call per transfer; a
    launch counts as bf16 when one of its levels is bf16."""
    import torch

    bf = torch.bfloat16
    visits = cycle_visits3d(len(levels), cfg)
    e = [0, 0]
    fg = [0, 0]
    for lvl, (lev, v) in enumerate(zip(levels, visits)):
        if lvl == len(levels) - 1:
            calls = [cfg.coarse_sweeps]
        else:
            calls = [cfg.pre_sweeps, cfg.post_sweeps] if smooth else []
            fg[0] += v
            fg[1] += v * (bf in (lev.dtype, levels[lvl + 1].dtype))
        n = v * sum(len(ks3.plan_passes(lev.grid.shape, s)) for s in calls)
        e[0] += n
        e[1] += n * (lev.dtype == bf)
    return {"rbgs3d": (e[0] * cycles, e[1] * cycles),
            "residual_restrict3d": (fg[0] * cycles, fg[1] * cycles),
            "prolong_correct3d": (fg[0] * cycles, fg[1] * cycles)}


def check_solve3d(label, res, steps, l2_ref, n, switches=None):
    """A phase 30-31 solve: finite, of shape n^3, converged in ``steps``
    outer steps (or iterations), l2 within L2_RTOL of ``l2_ref`` (when
    there is an exact solution), and its precision switches."""
    import torch

    info = res.info
    print(f"solve {label}: iterations {res.iterations} converged "
          f"{res.converged} errors {res.errors} switches "
          f"{info.get('precision_switches')} solve "
          f"{res.solve_time * 1e3:.3f} ms (first call, set-up included) "
          f"history {np.asarray(info['history']).tolist()}")
    if tuple(res.u.shape) != (n,) * 3 or not torch.isfinite(res.u).all():
        fail(f"{label}: solution is misshapen or not finite")
    if not res.converged or res.iterations != steps:
        fail(f"{label}: expected convergence in {steps} steps")
    if l2_ref is not None and abs(res.errors["l2"] / l2_ref - 1) > L2_RTOL:
        fail(f"{label}: l2 error {res.errors['l2']:.6e} not within "
             f"{L2_RTOL:.0%} of {l2_ref:.6e}")
    got = [list(s) for s in info.get("precision_switches", [])]
    if switches is not None and got != switches:
        fail(f"{label}: switches {got}, expected {switches}")


def counted3d(run, ks3, kx3):
    """``run()`` from every launch count reset to zero (the bf16 counts of
    E, F and G too); returns its result, the counts of every wrapper and
    E's, F's and G's (all, bf16) counts."""
    wrappers = (ks3.rbgs3d, kx3.residual_restrict3d, kx3.prolong_correct3d)
    for w in wrappers:
        w.launches_bf16 = 0
    out, got = counted_run(run)
    return out, got, {w.__name__: (w.launches, w.launches_bf16)
                      for w in wrappers}


def precision3d_path(mg, card, dev):
    """Phase 30: the 3D precisions on poisson3d_mms_sinsinsin: 'mixed' at
    513^3 (the twins' count, l2, E-G launches per plan with the bf16 ones
    apart, N's 1 + outer steps, ms per solve, busy share, peak memory), 'bf16' at 513^3 with
    BF16_3D_ITERS cycles (every level on E-G in bf16; the kernel path equal
    to the twin path bit for bit, its l2 at most the plain path's) and
    'adaptive' at 257^3 (the JAX package's iterations, switches and l2);
    returns the mixed solve's bf16 launches of E, F and G."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import refine3d as kr3, smooth3d as ks3, transfer3d as kx3

    start = time.perf_counter()
    bf = torch.bfloat16
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    prob = mg.poisson3d_mms_sinsinsin(N3)

    def mixed():
        return mg.solve_poisson3d(prob, precision="mixed", cfg=cfg,
                                  device=dev)

    torch.cuda.reset_peak_memory_stats(dev)
    n_before = kr3.refine_step3d.launches
    res, got, got3 = counted3d(mixed, ks3, kx3)
    peak = torch.cuda.max_memory_allocated(dev)
    check_solve3d(f"mixed {N3}^3 auto", res, MIXED3D_TWINS, MIXED3D_L2, N3)
    n_launches = kr3.refine_step3d.launches - n_before
    print(f"mixed {N3}^3: N launches {n_launches}, plan the start and "
          f"{res.iterations} outer steps")
    if n_launches != 1 + res.iterations:
        fail(f"mixed {N3}^3: N made {n_launches} launches, its plan "
             f"{1 + res.iterations}")
    levels = mg.build_hierarchy3d(prob.grid, policy=mg.policy("mixed"),
                                  device=dev, cfg=cfg)
    plan = cycle_plan3d(levels, cfg, res.iterations * IR_INNER_CYCLES, ks3)
    print(f"mixed {N3}^3: levels " + ", ".join(
        f"{lev.grid.nx}^3 {str(lev.dtype)[6:]}" for lev in levels)
        + f"; E-G launches (all, bf16) {got3}, plan {plan}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    check_launches(f"mixed {N3}^3", got,
                   {k: v[0] for k, v in plan.items()})
    if got3 != plan:
        fail(f"mixed {N3}^3: bf16 launches {got3} differ from the plan "
             f"{plan}")
    mixed_bf16 = {f"{k}_bf16": v[1] for k, v in got3.items()}
    del res
    # ms per solve: ir_solve3d with the right-hand side built on the card,
    # the mixed levels and the fp32 ones in turns (solve_poisson3d also
    # copies the problem's 1.08 GB host fields to the card on every call)
    fp32 = mg.build_hierarchy3d(prob.grid, device=dev, cfg=cfg)
    f3 = rhs3d(fp32, 0, 0, 1, dev)
    u03 = torch.zeros_like(f3)
    runs = {label: (lambda lv=lv: mg.ir_solve3d(lv, f3, u03, cfg,
                                                 inner_cycles=2))
            for label, lv in (("fp32", fp32), ("mixed", levels))}
    ms = {label: [] for label in runs}
    for label in ("fp32", "mixed", "mixed", "fp32"):
        ms[label].append(best_ms(runs[label], reps=2))
    for label, t in ms.items():
        print(f"solve time {label} {N3}^3 ir_solve3d: {min(t):.3f} ms per "
              f"solve ({t[0]:.3f}, {t[1]:.3f}; minimum of 2 in each turn) "
              f"[{card}]")
    torch.cuda.reset_peak_memory_stats(dev)
    runs["mixed"]()
    print(f"mixed {N3}^3 ir_solve3d: peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    profile_solve(f"mixed {N3}^3", runs["mixed"], {
        "rbgs3d": ks3.rbgs3d, "residual_restrict3d": kx3.residual_restrict3d,
        "prolong_correct3d": kx3.prolong_correct3d})
    del runs, f3, u03
    torch.cuda.empty_cache()

    # 'bf16': every level bf16; kernels, their twins on the card, plain
    bcfg = cfg.replace(max_iterations=BF16_3D_ITERS)

    def uniform(backend="auto"):
        return mg.solve_poisson3d(prob, precision="bf16", cfg=bcfg.replace(
            backend=backend), device=dev)

    res, got, got3 = counted3d(uniform, ks3, kx3)
    levels = mg.build_hierarchy3d(prob.grid, policy=mg.policy("bf16"),
                                  device=dev, cfg=cfg)
    plan = cycle_plan3d(levels, cfg, res.iterations, ks3)
    print(f"bf16 {N3}^3 auto: iterations {res.iterations} errors "
          f"{res.errors} history {res.info['history'].tolist()}; E-G "
          f"launches (all, bf16) {got3}, plan {plan}")
    if res.iterations != BF16_3D_ITERS or res.u.dtype != bf or \
            not torch.isfinite(res.u).all():
        fail(f"bf16 {N3}^3: {res.iterations} cycles of {res.u.dtype}, "
             f"expected {BF16_3D_ITERS} of bf16, finite")
    check_launches(f"bf16 {N3}^3", got, {k: v[0] for k, v in plan.items()})
    if got3 != plan:
        fail(f"bf16 {N3}^3: bf16 launches {got3} differ from {plan}")
    # the twin path: each kernel call replaced by its twin on the card
    saved = (ks3.rbgs3d, kx3.residual_restrict3d, kx3.prolong_correct3d)
    ks3.rbgs3d = lambda st, u, f, **kw: ks3.rbgs3d_plain(st, u.clone(), f,
                                                         **kw)
    kx3.residual_restrict3d = kx3.residual_restrict3d_plain
    kx3.prolong_correct3d = kx3.prolong_correct3d_plain
    try:
        twin = uniform()
    finally:
        ks3.rbgs3d, kx3.residual_restrict3d, kx3.prolong_correct3d = saved
    same = torch.equal(res.u, twin.u) and \
        res.info["history"].tolist() == twin.info["history"].tolist()
    print(f"bf16 {N3}^3: kernel path = twin path call by call: {same} "
          f"(max|du| {(res.u.float() - twin.u.float()).abs().max().item():.3e})")
    if not same:
        fail(f"bf16 {N3}^3: the kernel path differs from the twin path")
    del twin
    plain = uniform("torch")
    print(f"bf16 {N3}^3 torch (every op rounded to bf16): iterations "
          f"{plain.iterations} errors {plain.errors} history "
          f"{plain.info['history'].tolist()}")
    if res.errors["l2"] > plain.errors["l2"]:
        fail(f"bf16 {N3}^3: kernel l2 {res.errors['l2']:.6e} above the "
             f"plain path's {plain.errors['l2']:.6e}")
    del res, plain
    f3 = rhs3d(levels, 0, 0, 1, dev).to(bf)
    u03 = torch.zeros_like(f3)
    ms = best_ms(lambda: mg.mg_solve3d(levels, f3, u03, bcfg), reps=2)
    print(f"solve time bf16 {N3}^3 mg_solve3d ({BF16_3D_ITERS} cycles): "
          f"{ms:.3f} ms per solve (right-hand side on the card, minimum of "
          f"2) [{card}]")
    del f3, u03
    torch.cuda.empty_cache()

    # 'adaptive' at 257^3
    steps, l2, switches = PRECISION3D_REF["adaptive"]
    prob = mg.poisson3d_mms_sinsinsin(N3_REF)
    res, got, got3 = counted3d(lambda: mg.solve_poisson3d(
        prob, precision="adaptive", cfg=cfg, device=dev), ks3, kx3)
    check_solve3d(f"adaptive {N3_REF}^3 auto", res, steps, l2, N3_REF,
                  switches)
    print(f"adaptive {N3_REF}^3: stage factors {res.info['stage_factors']}; "
          f"E-G launches (all, bf16) {got3}")
    if not all(got3[k][0] > 0 for k in got3) or any(
            v[1] for v in got3.values()):
        fail(f"adaptive {N3_REF}^3: E-G launches {got3} (fp32 stages: "
             "launches, none on bf16)")
    del res, levels
    torch.cuda.empty_cache()
    print(f"phase 30: {time.perf_counter() - start:.1f} s")
    return mixed_bf16


def operator3d_path(mg, card, dev):
    """Phase 31: the 3D operator. jump_coefficient3d at 513^3 (fp32 under
    fp64 IR; coefficient levels: no E-G launch); at 257^3 neumann3d_test
    (reflect), periodic3d_helmholtz (wrap), anisotropic3d_z with line_z, a
    W-cycle Poisson solve (E-G per plan), coarsening='galerkin' on
    jump_coefficient3d (no E-G launch) and solve_heat3d CN with a
    coefficient field (5 steps, fp64; no E-G launch); each held to the JAX
    package's count and l2 (OPERATOR3D_REF); convergence_study3d at 33^3
    and 65^3."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.applications \
        import heat, heat3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth3d as ks3, transfer3d as kx3

    start = time.perf_counter()
    base = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    for key, (problem, n, changes) in OPERATOR3D_CASES.items():
        cfg = base.replace(**changes)
        prob = getattr(mg, problem)(n)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        res, got = counted_run(lambda: mg.solve_poisson3d(
            prob, precision="fp32", cfg=cfg, device=dev))
        peak = torch.cuda.max_memory_allocated(dev)
        steps, l2 = OPERATOR3D_REF[key]
        check_solve3d(f"{key} {problem}({n}) {changes}", res, steps, l2, n)
        if key == "w":
            levels = mg.build_hierarchy3d(prob.grid, device=dev, cfg=cfg)
            plan = cycle_plan3d(levels, cfg,
                                res.iterations * IR_INNER_CYCLES, ks3)
            plan = {k: v[0] for k, v in plan.items()}
        elif key == "line_z":
            # line_z smooths plain; F and G on every transfer, E the
            # coarsest RB-GS
            levels = mg.build_hierarchy3d(prob.grid, device=dev, cfg=cfg)
            plan = cycle_plan3d(levels, cfg,
                                res.iterations * IR_INNER_CYCLES, ks3,
                                smooth=False)
            plan = {k: v[0] for k, v in plan.items()}
        else:  # coefficient, Neumann, periodic or Stencil27 levels
            plan = {}
        check_launches(f"{key} {n}^3", got, plan)
        if key == "periodic":
            u = res.u
            dup = max((u[-1] - u[0]).abs().max().item(),
                      (u[:, -1] - u[:, 0]).abs().max().item(),
                      (u[..., -1] - u[..., 0]).abs().max().item())
            if dup != 0:
                fail(f"periodic {n}^3: duplicate nodes differ from node 0 "
                     f"({dup:.3e})")
        print(f"{key} {n}^3: {(time.perf_counter() - t0) * 1e3:.1f} ms "
              f"(first call), peak memory {peak / 2**30:.3f} GiB [{card}]")
        del res
        torch.cuda.empty_cache()
    # solve_heat3d CN with a = 1 + x + y + z, fp64 (scripts/reference3d.py)
    n = N3_REF
    prob = heat3d.pure_diffusion3d(n)
    x, y, z = prob.grid.axes()
    prob.a = 1.0 + x[:, None, None] + y[None, :, None] + z[None, None, :]
    hcfg = heat.HeatConfig(dtype="float64", mg=base)
    t0 = time.perf_counter()
    out, got = counted_run(lambda: mg.solve_heat3d(
        prob, HEAT3D_A_STEPS * HEAT3D_A_DT, HEAT3D_A_DT, hcfg, device=dev))
    steps, l2 = OPERATOR3D_REF["heat_a"]
    print(f"heat3d CN with a {n}^3 fp64: steps {out['steps']} errors "
          f"{out['errors']} ({(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"first call) [{card}]")
    check_launches(f"heat3d with a {n}^3", got, {})
    if out["steps"] != steps or not torch.isfinite(out["u"]).all() or \
            abs(out["errors"]["l2"] / l2 - 1) > L2_RTOL:
        fail(f"heat3d with a: steps {out['steps']} l2 "
             f"{out['errors']['l2']:.6e}, the JAX package's {steps}, "
             f"{l2:.6e}")
    del out
    torch.cuda.empty_cache()
    study = mg.convergence_study3d(mg.poisson3d_mms_sinsinsin, [33, 65],
                                   device=dev)
    print(f"convergence_study3d (33^3, 65^3, fp64): {study}")
    if not study["converged"] or abs(study["order_l2"] - 2.0) > 0.1:
        fail(f"convergence_study3d: observed l2 order "
             f"{study['order_l2']:.4f}, not 2")
    print(f"phase 31: {time.perf_counter() - start:.1f} s")


def kernel_phase_var_bf16(mg, card, dev):
    """Phase 32: H, I, J and L on bf16 storage against their twins (which
    widen, run the fp32 twin and round once), bit for bit, on data from the
    seed at the 1025^2 path's shapes: H at 1025^2, 513^2 and 257^2 of the
    bf16 jump hierarchy (RB-GS, reversed, Jacobi, 5 SOR sweeps in two
    launches) and with 32 sweeps (eight launches) at 17^2; I from the same
    levels into bf16 and fp32, from the 'mixed' hierarchy's last fp32 level
    into its first bf16 one, and on Robin sides; J from 129^2 on a bf16
    entry and on the 'mixed' tail (an fp32 entry over bf16 levels); L at
    1025^2, 513^2 and 257^2 (1, 2, 3 and 5 sweeps), equal to A too; H's
    and L's row alignment cases (bf16_row_checks).
    CUDA-event ms of kernel and twin at the record's shape, and device ms
    per call on bf16 beside the same call on fp32."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv, tail as kt, transfer as kx

    start = time.perf_counter()
    bf = torch.bfloat16
    rng = np.random.default_rng(3232)

    def field(shape, scale=1.0, dtype=bf, ring=False):
        a = np.zeros(shape, np.float32)
        if ring:
            a[:] = scale * rng.standard_normal(shape)
        else:
            a[1:-1, 1:-1] = scale * rng.standard_normal(
                (shape[0] - 2, shape[1] - 2))
        return torch.from_numpy(a).to(dev).to(dtype)

    def widened(fn):  # the difference is taken in fp32
        return lambda *a: fn(*a).float()

    clocks("phase 32's device readings")
    probs = var_problems(mg)
    jump, robin = probs["jump"], probs["robin"]
    hier = {mode: mg.build_hierarchy(jump.grid, jump.spec, a=jump.a,
                                     policy=mg.policy(mode), device=dev)
            for mode in ("bf16", "fp32", "mixed")}
    errs, times, dev_ms = {}, {}, {}
    two = dict(method="rbgs", sweeps=2, omega=1.0)
    for lev, lev32 in zip(hier["bf16"][:3], hier["fp32"][:3]):
        n, st = lev.grid.nx, lev.stencil
        u, f = field((n, n)), field((n, n), 1e3)
        for method, sweeps, omega in (("rbgs", 2, 1.0), ("rbgs_rev", 2, 1.0),
                                      ("jacobi", 2, 0.8), ("sor", 5, 1.3)):
            kw = dict(method=method, sweeps=sweeps, omega=omega)
            compare("smooth_var_bf16", f"jump {n}^2 bf16 {kw}",
                    widened(lambda a, b: ksv.multisweep_var(st, a, b, **kw)),
                    widened(lambda a, b: ksv.multisweep_plain(st, a, b,
                                                              **kw)),
                    lambda: (u.clone(), f), errs, exact=True)
        u32, f32 = u.float(), f.float()
        bf_ms = dev_ms[("smooth_var_bf16", n)] = device_ms_per_call(
            lambda: ksv.multisweep_var(st, u, f, **two), 20, "smooth_var")
        fp_ms = device_ms_per_call(
            lambda: ksv.multisweep_var(lev32.stencil, u32, f32, **two), 20,
            "smooth_var")
        print(f"H {n}^2 2-sweep RB-GS call: device {bf_ms:.4f} ms per call "
              f"on bf16, {fp_ms:.4f} on fp32 [{card}]")
        if n == N_VAR:
            times[("smooth_var_bf16", n)] = (
                time_ms(lambda: ksv.multisweep_var(st, u, f, **two)),
                time_ms(lambda: ksv.multisweep_plain(st, u.clone(), f,
                                                     **two)))
    lev = next(lev for lev in hier["bf16"] if lev.grid.nx == 17)
    st, u, f = lev.stencil, field((17, 17)), field((17, 17), 1e3)
    compare("smooth_var_bf16", "jump 17^2 bf16 32 sweeps (8 launches)",
            widened(lambda a, b: ksv.multisweep_var(st, a, b, sweeps=32)),
            widened(lambda a, b: ksv.multisweep_plain(st, a, b, sweeps=32)),
            lambda: (u.clone(), f), errs, exact=True)
    bf16_row_checks(mg, ks, ksv, field, widened, errs, dev)
    # H and L on a u and an f of two storages: H on the jump levels (its
    # planes in u's dtype), L on the Poisson ones, and a field narrower
    # than a tile
    g9 = mg.Grid(9, 61)
    X, Y = g9.coordinates()
    mixed_pairing_checks(
        "smooth_var_bf16",
        [(lev.stencil, lev.grid.shape, 1e3)
         for lev in (hier["fp32"][0], hier["fp32"][2])]
        + [(stencil.make_stencil(g9, a=np.where(X < 0.5, 1.0, 1e3) + Y,
                                 device=dev), g9.shape, 1e3)],
        ksv.multisweep_var, ksv.multisweep_plain, ksv.multisweep_var, field,
        widened, errs,
        (("rbgs", 1.0), ("rbgs_rev", 1.0), ("jacobi", 0.8), ("sor", 1.3)))
    pois = mg.build_hierarchy(mg.Grid(N, N), device=dev)
    mixed_pairing_checks(
        "smooth_parity_bf16",
        [(lev.stencil, lev.grid.shape, lev.stencil.c)
         for lev in (pois[0], pois[2])]
        + [(stencil.make_stencil(g9), g9.shape, 1.0)],
        lambda st, a, b, **kw: ks.multisweep(st, a, b, layout="parity",
                                             **kw),
        lambda st, a, b, method, **kw: ks.multisweep_parity_plain(st, a, b,
                                                                  **kw),
        ks.multisweep_parity, field, widened, errs,
        (("rbgs", 1.0), ("sor", 1.3)))
    del pois

    for lev, lev32 in zip(hier["bf16"][:3], hier["fp32"][:3]):
        n, st, nc = lev.grid.nx, lev.stencil, lev.grid.coarsen().nx
        u, f = field((n, n)), field((n, n), 1e3)
        for out in (bf, torch.float32):
            i_offset_checks(kx, st, u, f, f"jump {n}->{nc} bf16->"
                            f"{str(out)[6:]}", errs, out=out,
                            name="residual_restrict_var_bf16")
        u32, f32 = u.float(), f.float()
        bf_ms = dev_ms[("residual_restrict_var_bf16", n)] = \
            device_ms_per_call(lambda: kx.residual_restrict_var(st, u, f), 20,
                               "residual_restrict_var")
        fp_ms = device_ms_per_call(lambda: kx.residual_restrict_var(
            lev32.stencil, u32, f32), 20, "residual_restrict_var")
        print(f"I {n}->{nc}: device {bf_ms:.4f} ms per call on bf16, "
              f"{fp_ms:.4f} on fp32 [{card}]")
        if n == N_VAR:
            times[("residual_restrict_var_bf16", n)] = (
                time_ms(lambda: kx.residual_restrict_var(st, u, f)),
                time_ms(lambda: kx.residual_restrict_plain(st, u, f)))
    mixed = hier["mixed"]
    k = next(i for i in range(len(mixed) - 1)
             if mixed[i + 1].dtype == bf and mixed[i].dtype != bf)
    st, n, nc = mixed[k].stencil, mixed[k].grid.nx, mixed[k + 1].grid.nx
    u, f = field((n, n), dtype=torch.float32), field(
        (n, n), 1e3, torch.float32)
    i_offset_checks(kx, st, u, f, f"jump mixed {n}->{nc} fp32->bf16", errs,
                    out=bf, name="residual_restrict_var_bf16")
    rl = mg.build_hierarchy(robin.grid, robin.spec, policy=mg.policy("bf16"),
                            device=dev)
    sides = robin.spec.dirichlet_sides
    for k, lev in enumerate(rl[:-1]):  # I on every Robin level
        n, st, nc = lev.grid.nx, lev.stencil, lev.grid.coarsen().nx
        u, f = field((n, n), ring=True), field((n, n), 50.0, ring=True)
        i_offset_checks(kx, st, u, f, f"robin {n}->{nc} bf16", errs,
                        sides=sides, name="residual_restrict_var_bf16")
        if k >= 2:
            continue
        ec = field((nc, nc), ring=True)
        compare("prolong_correct_bf16", f"robin sides {nc}->{n} bf16",
                widened(lambda a, b: kx.prolong_correct(a, b, sides=sides)),
                widened(lambda a, b: kx.prolong_correct_plain(a, b,
                                                              sides=sides)),
                lambda: (ec, u.clone()), errs, exact=True)

    kw = dict(pre=2, post=2, omega=1.0, method="rbgs", coarse_sweeps=32,
              symmetric=False)
    for label in ("bf16", "mixed"):
        tail = [lev for lev in hier[label] if lev.grid.nx <= TAIL_ENTRY]
        sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                       for lev in tail]
        dt = tail[0].dtype
        print(f"J {label} tail: " + ", ".join(
            f"{lev.grid.nx}^2 {str(lev.dtype)[6:]}" for lev in tail))
        u0, f = field(shapes[0], dtype=dt), field(shapes[0], 1e3, dt)
        for sym in (False, True):
            kws = dict(kw, symmetric=sym)
            compare("tail_vcycle_var_bf16", f"jump {shapes[0][0]}^2 "
                    f"L={len(tail)} {label} tail symmetric={sym}",
                    widened(lambda a, b: kt.tail_vcycle_var(
                        sts, a, b, shapes=shapes, **kws)),
                    widened(lambda a, b: kt.tail_vcycle_plain(
                        sts, a, b, shapes=shapes, **kws)),
                    lambda: (u0.clone(), f), errs, exact=True)
        ms = device_ms(lambda: kt.tail_vcycle_var(sts, u0, f, shapes=shapes,
                                                  **kw), "tail_var", reps=20)
        if label == "bf16":
            dev_ms[("tail_vcycle_var_bf16", TAIL_ENTRY)] = ms
            times[("tail_vcycle_var_bf16", TAIL_ENTRY)] = (
                time_ms(lambda: kt.tail_vcycle_var(sts, u0.clone(), f,
                                                   shapes=shapes, **kw)),
                time_ms(lambda: kt.tail_vcycle_plain(
                    sts, u0.clone(), f, shapes=shapes, **kw)))
            sts32 = [lev.stencil for lev in hier["fp32"]
                     if lev.grid.nx <= TAIL_ENTRY]
            u32, f32 = u0.float(), f.float()
            ms32 = device_ms(lambda: kt.tail_vcycle_var(
                sts32, u32, f32, shapes=shapes, **kw), "tail_var", reps=20)
            print(f"J from {TAIL_ENTRY}^2: device {ms:.4f} ms per launch on "
                  f"a bf16 tail, {ms32:.4f} on fp32 [{card}]")
        else:
            print(f"J from {TAIL_ENTRY}^2: device {ms:.4f} ms per launch on "
                  f"the mixed tail [{card}]")

    par = mg.build_hierarchy(mg.Grid(N, N), policy=mg.policy("bf16"),
                             device=dev)
    par32 = mg.build_hierarchy(mg.Grid(N, N), device=dev)
    for lev, lev32 in zip(par[:3], par32[:3]):
        n, st = lev.grid.nx, lev.stencil
        u, f = field((n, n)), field((n, n), st.c)
        for sweeps, omega in ((1, 1.0), (2, 1.0), (3, 1.3), (5, 1.0)):
            kw = dict(sweeps=sweeps, omega=omega)
            compare("smooth_parity_bf16", f"{n}^2 bf16 {kw}", widened(
                lambda a, b: ks.multisweep(st, a, b, layout="parity", **kw)),
                widened(lambda a, b: ks.multisweep_parity_plain(
                    st, a, b, **kw)), lambda: (u.clone(), f), errs,
                exact=True)
            compare("smooth_parity_bf16", f"{n}^2 bf16 {kw} against A",
                    widened(lambda a, b: ks.multisweep(
                        st, a, b, layout="parity", **kw)),
                    widened(lambda a, b: ks.multisweep(
                        st, a, b, layout="direct", **kw)),
                    lambda: (u.clone(), f), errs, exact=True)
        u32, f32 = u.float(), f.float()
        bf_ms = dev_ms[("smooth_parity_bf16", n)] = device_ms_per_call(
            lambda: ks.multisweep(st, u, f, layout="parity"), 20,
            "parity_kernel")
        fp_ms = device_ms_per_call(lambda: ks.multisweep(
            lev32.stencil, u32, f32, layout="parity"), 20, "parity_kernel")
        print(f"L {n}^2 2-sweep call: device {bf_ms:.4f} ms per call on "
              f"bf16, {fp_ms:.4f} on fp32 [{card}]")
        if n == N:
            times[("smooth_parity_bf16", n)] = (
                time_ms(lambda: ks.multisweep(st, u, f, layout="parity")),
                time_ms(lambda: ks.multisweep_parity_plain(st, u.clone(),
                                                           f)))
    for (name, n), (k_ms, p_ms) in times.items():
        print(f"time {name} {n}^2: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms [{card}]")
    print(f"phase 32: {time.perf_counter() - start:.1f} s")
    return errs, times, dev_ms


def bf16_row_checks(mg, ks, ksv, field, widened, errs, dev):
    """Phase 32: L's bf16 window rows come in as aligned 4-byte words
    (common.cuh load_windows), each row's shift read from its element
    address; H's nodes as 2-byte loads. H (RB-GS, Jacobi, 5 SOR sweeps in
    two launches) and L (2 and 5 sweeps, against its twin and A) on
    BF16_ROW_SHAPES with u, f and H's planes in views at BF16_ROW_OFFSETS:
    against their twins bit for bit."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import stencil

    bf = torch.bfloat16

    for shape in BF16_ROW_SHAPES:
        g = mg.Grid(*shape)
        X, Y = g.coordinates()
        st32 = stencil.make_stencil(g, a=np.where(X < 0.5, 1.0, 1e3) + Y,
                                    device=dev)
        sp = stencil.make_stencil(g)
        u, f, fp = field(shape, ring=True), field(shape, 1e3), field(
            shape, sp.c)
        for ou, of, op in BF16_ROW_OFFSETS:
            st = stencil.Stencil(*(
                at_offset(x.to(bf), k % 2 if op == "alt" else op)
                for k, x in enumerate(st32.coefs)))
            for method, sweeps, omega in (("rbgs", 2, 1.0),
                                          ("jacobi", 2, 0.8),
                                          ("sor", 5, 1.3)):
                kw = dict(method=method, sweeps=sweeps, omega=omega)
                compare("smooth_var_bf16", f"{shape} bf16 {kw} u at offset "
                        f"{ou}, f at {of}, planes at {op}",
                        widened(lambda a, b: ksv.multisweep_var(st, a, b,
                                                                **kw)),
                        widened(lambda a, b: ksv.multisweep_plain(st, a, b,
                                                                  **kw)),
                        lambda: (at_offset(u, ou), at_offset(f, of)), errs,
                        exact=True)
            for sweeps in (2, 5):
                kw = dict(sweeps=sweeps, omega=1.0)
                for label, plain in (
                        ("", lambda a, b: ks.multisweep_parity_plain(
                            sp, a, b, **kw)),
                        (" against A", lambda a, b: ks.multisweep(
                            sp, a, b, layout="direct", **kw))):
                    compare("smooth_parity_bf16", f"{shape} bf16 {kw} u at "
                            f"offset {ou}, f at {of}{label}",
                            widened(lambda a, b: ks.multisweep(
                                sp, a, b, layout="parity", **kw)),
                            widened(plain),
                            lambda: (at_offset(u, ou), at_offset(fp, of)),
                            errs, exact=True)
        del u, f, fp
    torch.cuda.empty_cache()


def var_cycle_plan(levels, cycles, robin):
    """(all, bf16) launches of H, I, C and J in ``cycles`` V-cycles of the
    2D varcoef path over ``levels``: above the tail, H once per 2-sweep call
    (pre and post), I and C once per transfer; J once per cycle from the
    first level of at most TAIL_ENTRY; a Robin hierarchy has no H and no J
    (its sides are not Dirichlet), and I and C on every transfer. A launch
    is bf16 when a level it touches is (J: its entry)."""
    import torch

    bf = torch.bfloat16
    plan = {k: [0, 0] for k in ("smooth_var", "residual_restrict_var",
                                "prolong_correct", "tail_vcycle_var")}
    for lvl, lev in enumerate(levels[:-1]):
        if not robin and lev.grid.nx <= TAIL_ENTRY:
            plan["tail_vcycle_var"] = [1, int(lev.dtype == bf)]
            break
        if not robin:
            plan["smooth_var"][0] += 2
            plan["smooth_var"][1] += 2 * (lev.dtype == bf)
        either = bf in (lev.dtype, levels[lvl + 1].dtype)
        for k in ("residual_restrict_var", "prolong_correct"):
            plan[k][0] += 1
            plan[k][1] += int(either)
    return {k: (v[0] * cycles, v[1] * cycles) for k, v in plan.items()}


def _add_plans(*plans):
    return {k: tuple(sum(p[k][i] for p in plans) for i in (0, 1))
            for k in plans[0]}


def var_precision_path(mg, card, dev):
    """Phase 33: the 2D variable-coefficient precisions at 1025^2:
    solve_poisson(precision='mixed' | 'bf16') and adaptive_solve(start=BF16)
    on var_problems. The kernel path is held to the kernels' CPU twins'
    count (VAR_PRECISION_TWINS) and l2, to the twin path on the card (every
    kernel call replaced by its twin) bit for bit, and to the launch plan
    of H, I, C and J, bf16 launches apart (the 'mixed' jump solve takes J
    from 129^2 on an fp32 entry over bf16 levels); the plain path to the
    JAX package's count, switches and l2 (VAR_PRECISION_REF). Then the
    1025^2 Poisson 'bf16' solve with the parity layout (kernel L on bf16
    levels), held to its plan and to its twin path; ms per solve and busy
    shares. Returns the bf16 launches of H, I, J and L."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth as ks, smooth_var as ksv, tail as kt, transfer as kx

    start = time.perf_counter()
    bf = torch.bfloat16
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    counted = {"smooth_var": ksv.multisweep_var,
               "residual_restrict_var": kx.residual_restrict_var,
               "prolong_correct": kx.prolong_correct,
               "tail_vcycle_var": kt.tail_vcycle_var}
    var_twins = {(ksv, "multisweep_var"): ks.multisweep_plain,
                 (kx, "residual_restrict_var"): kx.residual_restrict_plain,
                 (kx, "prolong_correct"): kx.prolong_correct_plain,
                 (kt, "tail_vcycle_var"): kt.tail_vcycle_plain}

    def solve(prob, precision, backend="auto"):
        c = cfg.replace(backend=backend)
        t0 = time.perf_counter()
        if precision == "bf16_start":
            u, info = mg.adaptive_solve(
                prob.grid, prob.spec, prob.rhs(torch.float64, dev),
                prob.initial_guess(torch.float64, dev), a=prob.a,
                lam=prob.lam, cfg=c, start=mg.Precision.BF16, device=dev)
        else:
            if precision == "bf16":
                c = c.replace(max_iterations=BF16_VAR_CYCLES)
            res = mg.solve_poisson(prob, precision=precision, cfg=c,
                                   device=dev)
            u, info = res.u, res.info
        torch.cuda.synchronize()
        l2 = prob.error_norms(u)["l2"] if prob.exact is not None else None
        return types.SimpleNamespace(
            u=u, info=info, iterations=info["iterations"], l2=l2,
            switches=[tuple(s) for s in info.get("precision_switches", [])],
            seconds=time.perf_counter() - t0)

    def twin_path(run, twins=var_twins):
        """``run()`` with every kernel wrapper of ``twins`` replaced by its
        twin (on the card)."""
        saved = {key: getattr(*key) for key in twins}
        for (mod, name), twin in twins.items():
            setattr(mod, name, twin)
        try:
            return run()
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)

    def held(label, res, ref, slack, l2_rule):
        steps, l2, switches = ref
        print(f"solve {label}: iterations {res.iterations} l2 {res.l2} "
              f"switches {res.switches} (reference {ref}) "
              f"{res.seconds * 1e3:.3f} ms (first call)")
        if tuple(res.u.shape) != (N_VAR, N_VAR) or \
                not torch.isfinite(res.u.float()).all():
            fail(f"{label}: the solution is misshapen or not finite")
        if abs(res.iterations - steps) > slack or \
                [s[1] for s in res.switches] != [s[1] for s in switches]:
            fail(f"{label}: {res.iterations} iterations, switches "
                 f"{res.switches}; expected {steps} +- {slack}, {switches}")
        if l2 is not None and not l2_rule(res.l2, l2):
            fail(f"{label}: l2 {res.l2:.6e} against the reference "
                 f"{l2:.6e}")

    def within(got, ref):
        return abs(got / ref - 1) <= L2_RTOL

    def robin_rule(got, ref):  # Robin: the tolerance sets the l2
        return got <= ROBIN_L2_FACTOR * ref

    bf16_launches = dict.fromkeys(("smooth_var_bf16",
                                   "residual_restrict_var_bf16",
                                   "tail_vcycle_var_bf16"), 0)
    timing = {}
    for name, prob in var_problems(mg).items():
        robin = name == "robin"
        for precision in ("mixed", "bf16", "bf16_start"):
            label = f"{name} {precision} {N_VAR}^2"
            for w in counted.values():
                w.launches_bf16 = 0
            res, got = counted_run(lambda: solve(prob, precision))
            got_bf = {k: w.launches_bf16 for k, w in counted.items()}
            ref = VAR_PRECISION_TWINS[(name, precision)]
            rule = robin_rule if robin and precision == "mixed" else within
            held(f"{label} auto", res, ref,
                 1 if precision == "bf16_start" else 0, rule)
            if precision == "bf16_start":
                first = res.switches[0][0]
                plan = _add_plans(
                    var_cycle_plan(mg.build_hierarchy(
                        prob.grid, prob.spec, a=prob.a,
                        policy=mg.policy("bf16"), device=dev), first, robin),
                    var_cycle_plan(mg.build_hierarchy(
                        prob.grid, prob.spec, a=prob.a, device=dev),
                        res.iterations - first, robin))
            else:
                cycles = res.iterations * (IR_INNER_CYCLES
                                           if precision == "mixed" else 1)
                plan = var_cycle_plan(mg.build_hierarchy(
                    prob.grid, prob.spec, a=prob.a,
                    policy=mg.policy(precision), device=dev), cycles, robin)
            mine = {k: (got[k], got_bf[k]) for k in counted}
            print(f"{label} auto: launches (all, bf16) {mine}, plan {plan}")
            if mine != plan or any(v for k, v in got.items()
                                   if k not in counted):
                fail(f"{label}: launches {got} (bf16 {got_bf}) differ from "
                     f"the plan {plan}")
            for k in bf16_launches:
                bf16_launches[k] += got_bf[k[:-len("_bf16")]]
            twin = twin_path(lambda: solve(prob, precision))
            same = torch.equal(res.u, twin.u) and np.array_equal(
                np.asarray(res.info["history"]),
                np.asarray(twin.info["history"]))
            print(f"{label}: kernel path = twin path call by call: {same}")
            if not same:
                fail(f"{label}: the kernel path differs from the twin path")
            plain = solve(prob, precision, "torch")
            held(f"{label} torch", plain, VAR_PRECISION_REF[(name,
                                                            precision)],
                 1 if precision == "bf16_start" else 0, rule)
            timing[label] = best_ms(lambda: solve(prob, precision))
            print(f"solve time {label} auto: {timing[label]:.3f} ms per "
                  f"solve (set-up included, minimum of 3) [{card}]")
        # the fp32 solve beside the mixed one, timed in turns (the host's
        # load drifts between solves timed apart)
        turns = {"mixed": [], "fp32": []}
        for _ in range(5):
            for precision in turns:
                turns[precision].append(best_ms(
                    lambda: solve(prob, precision), reps=1))
        mixed, fp32 = min(turns["mixed"]), min(turns["fp32"])
        print(f"solve time {name} fp32 {N_VAR}^2 auto: {fp32:.3f} ms per "
              f"solve, mixed {mixed:.3f} (set-up included, minimum of 5 "
              f"taken in turns); mixed / fp32 {mixed / fp32:.3f} [{card}]")
    probs = var_problems(mg)
    profile_solve(f"jump mixed {N_VAR}^2", lambda: solve(probs["jump"],
                                                          "mixed"), counted)
    profile_solve(f"varcoef bf16 {N_VAR}^2", lambda: solve(
        probs["varcoef"], "bf16"), counted)

    # kernel L on bf16 levels: the Poisson 'bf16' solve, parity layout
    prob = mg.poisson_mms_sinsin(N)
    pcfg = cfg.replace(max_iterations=BF16_VAR_CYCLES)
    wrappers = {"smooth_parity": ks.multisweep_parity,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}

    def parity_solve():
        return mg.solve_poisson(prob, precision="bf16", cfg=pcfg, device=dev)

    saved = ks.PARITY_DEFAULT
    ks.PARITY_DEFAULT = True
    try:
        for w in wrappers.values():
            w.launches_bf16 = 0
        res, got = counted_run(parity_solve)
        got_bf = {k: w.launches_bf16 for k, w in wrappers.items()}
        levels = mg.build_hierarchy(prob.grid, policy=mg.policy("bf16"),
                                    device=dev)
        # cycle_launches counts IR_INNER_CYCLES cycles per iteration; this
        # mg_solve runs one
        plan = {k: v // IR_INNER_CYCLES for k, v in cycle_launches(
            levels, cfg, res.iterations).items()}
        want = {"smooth_parity": plan["smooth_multisweep"],
                **{k: plan[k] for k in ("residual_restrict",
                                        "prolong_correct", "tail_vcycle")}}
        print(f"poisson bf16 {N}^2 parity layout: {res.iterations} cycles, "
              f"launches {got}, bf16 {got_bf}, plan {want} (all bf16); l2 "
              f"{res.errors['l2']:.6e}")
        if res.iterations != BF16_VAR_CYCLES or res.u.dtype != bf or \
                not torch.isfinite(res.u.float()).all():
            fail(f"poisson bf16 parity: {res.iterations} cycles of "
                 f"{res.u.dtype}")
        check_launches(f"poisson bf16 {N}^2 parity", got, want)
        if got_bf != want:
            fail(f"poisson bf16 parity: bf16 launches {got_bf}, plan {want}")
        twin = twin_path(parity_solve, {
            (ks, "multisweep_parity"): lambda st, u, f, **kw:
                ks.multisweep_parity_plain(st, u.clone(), f, **kw),
            (kx, "residual_restrict"): kx.residual_restrict_plain,
            (kx, "prolong_correct"): kx.prolong_correct_plain,
            (kt, "tail_vcycle"): kt.tail_vcycle_plain})
        same = torch.equal(res.u, twin.u)
        print(f"poisson bf16 {N}^2 parity: kernel path = twin path call by "
              f"call: {same}")
        if not same:
            fail("poisson bf16 parity: the kernel path differs from the "
                 "twin path")
        parity_bf16 = got_bf["smooth_parity"]
        timing["poisson bf16 parity"] = best_ms(parity_solve)
        print(f"solve time poisson bf16 {N}^2 parity layout: "
              f"{timing['poisson bf16 parity']:.3f} ms per solve [{card}]")
    finally:
        ks.PARITY_DEFAULT = saved
    print(f"phase 33: {time.perf_counter() - start:.1f} s")
    return {**bf16_launches, "smooth_parity_bf16": parity_bf16}


def halo_path(card):
    """Phase 34: halo_solve over NCCL, one rank per visible card (the
    launcher spawns them, each on its card), on the mesh of the whole world:
    poisson_mms_sinsin(1025) and jump_coefficient_problem(1025), fp64 RB-GS
    V(2,2), held to the port's mg_solve on the same card (iterations, and
    the solution within HALO_ATOL); shard_smooth (bit for bit against the
    plain smoother), global_residual_norm (rel 1e-12) and
    make_sharded_field (every block and the gathered field exact) on the
    same mesh. Prints the world size, the mesh and the plan's sharded
    depth S; a rank that fails fails the phase. On one card the world is
    one rank and the plan splits nothing (S = 0): halo_solve is then
    mg_solve itself, and the phase checks the launch, the NCCL bring-up and
    the sharded field, not halos."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import \
        checks, launch

    start = time.perf_counter()
    world = torch.cuda.device_count()
    C = checks.Case
    cases = {  # on the mesh of the whole world
        "global_poisson": C("solve", "poisson_mms_sinsin", N, None),
        "global_jump": C("solve", "jump_coefficient_problem", N, None,
                         changes={"max_iterations": 60}),
        "global_shard_smooth": C("smooth", "poisson_mms_sinsin", N, None),
        "global_norm": C("norm", "poisson_mms_sinsin", N, None),
        "global_field": C("field", "poisson_mms_sinsin", N, None),
    }
    try:
        res = launch.run(checks.run_cases, world, cases, "cuda",
                         backend="nccl", timeout=300.0)
    except RuntimeError as exc:
        fail(f"phase 34: {exc}")
    for r in res:
        summary = r["summary"]
        if summary["backend"] != "nccl" or \
                summary["process_count"] != world:
            fail(f"phase 34: rank {r['rank']} ran {summary}")
    print(f"phase 34: world {world} NCCL rank(s), {res[0]['summary']}")
    for name in ("global_poisson", "global_jump"):
        r = res[0][name]
        for other in res[1:]:
            if not np.array_equal(other[name]["u"], r["u"]):
                fail(f"{name}: rank {other['rank']} holds another solution")
        print(f"halo_solve {name} {N}^2 fp64 on mesh {r['mesh']}: sharded "
              f"depth S {r['n_sharded']}, iterations {r['iterations']} "
              f"(mg_solve {r['ref_iterations']}), converged "
              f"{r['converged']}, max|u - u_mg_solve| {r['max_diff_ref']:.3e}"
              f", l2 {r.get('l2')}; rank 0's first call {r['seconds']:.3f} s "
              f"(mg_solve {r['ref_seconds']:.3f} s) [{card}]")
        if not r["converged"] or r["iterations"] != r["ref_iterations"] or \
                r["max_diff_ref"] > HALO_ATOL:
            fail(f"{name}: halo_solve differs from mg_solve")
    r = res[0]["global_shard_smooth"]
    print(f"shard_smooth {N}^2: equal to the plain smoother: jacobi "
          f"{r['jacobi']['equal']}, rbgs {r['rbgs']['equal']}")
    if not (r["jacobi"]["equal"] and r["rbgs"]["equal"]):
        fail("shard_smooth differs from the plain smoother")
    r = res[0]["global_norm"]
    print(f"global_residual_norm {N}^2: {r['norm']!r} (plain {r['ref']!r})")
    if abs(r["norm"] / r["ref"] - 1) > 1e-12:
        fail("global_residual_norm differs from the plain norm")
    r = res[0]["global_field"]
    print(f"make_sharded_field {N}^2: spec {r['spec']}, block "
          f"{r['block_shape']}, block exact {r['block_equal']}, gather exact "
          f"{r['gather_equal']}")
    if not (r["block_equal"] and r["gather_equal"]):
        fail("make_sharded_field differs from the global field")
    print(f"phase 34: {time.perf_counter() - start:.1f} s")


def sharded_path(card, *, graded: bool = False, repeats: int = 0):
    """Phase 35: the GSPMD path (``parallel.distributed``) over NCCL, one
    rank per visible card (the launcher spawns them, each on its card), on
    the mesh of the whole world, at 1025^2: ``solve_poisson(mesh=)`` on
    poisson_mms_sinsin in 'fp64', 'mixed' and 'adaptive' (tol 1e-9),
    ``sharded_solve`` with ADI on poisson_mms_anisotropic (ay = 0.01, tol
    1e-10) and on the Galerkin jump_coefficient_problem (RB-GS V(2,2)),
    and CG to 1e-10 on ``shard_inputs`` vectors preconditioned by a
    symmetric V(2,2) cycle with ``make_constrainer``, all on backend
    'auto'. Each is held on every rank to the same call on a one-rank mesh
    (the single-device solve under the hook: equal iterations, fp64
    solutions within SHARDED_ATOL, the same launches of the smoothing
    kernels A and H, at least one in 'mixed' and 'adaptive', where kernel
    A smooths the fp32 and bf16 levels, the split ones on haloed windows)
    and printed beside the single-device plain solve; every rank must
    return the same solution. ``graded`` adds the Poisson fp64
    ``sharded_solve`` on the graded mesh (xo, xi, yo, yi) = (2, 2, 1, 1)
    (four cards or more); ``repeats`` times that many more calls of each
    solve, the sharded one, the one-rank one, the plain and the kernel
    path's, and prints their minimum (set-up
    included) beside rank 0's first call. On one card the world is one
    rank and no level is split: the phase then checks the launch, NCCL
    and the plumbing of every entry point, not halos."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import \
        checks, launch

    start = time.perf_counter()
    world = torch.cuda.device_count()
    C = checks.Case
    front = {"tol": 1e-9, "max_iterations": 100, "backend": "auto"}
    cases = {  # on the mesh of the whole world
        "fp64": C("frontend", "poisson_mms_sinsin", N, None, changes=front,
                  options={"precision": "fp64", "repeats": repeats}),
        "mixed": C("frontend", "poisson_mms_sinsin", N, None, changes=front,
                   options={"precision": "mixed", "repeats": repeats}),
        "adaptive": C("frontend", "poisson_mms_sinsin", N, None,
                      changes=front,
                      options={"precision": "adaptive", "repeats": repeats}),
        "adi": C("sharded", "poisson_mms_anisotropic", N, None,
                 changes={"smoother": "adi", "omega": 0.8,
                          "max_iterations": 100, "tol": 1e-10,
                          "backend": "auto"},
                 options={"repeats": repeats}),
        "galerkin_jump": C("sharded", "jump_coefficient_problem", N, None,
                           changes={"coarsening": "galerkin",
                                    "max_iterations": 60,
                                    "backend": "auto"},
                           options={"repeats": repeats}),
        "mg_pcg": C("pcg", "poisson_mms_sinsin", N, None,
                    changes={"symmetric": True, "backend": "auto"},
                    options={"tol": 1e-10, "maxiter": 30,
                             "repeats": repeats}),
    }
    if graded and world >= 4:
        cases["graded_fp64"] = C("sharded", "poisson_mms_sinsin", N,
                                 (2, 2, 1, 1), changes={"backend": "auto"},
                                 options={"repeats": repeats})
    try:
        res = launch.run(checks.run_cases, world, cases, "cuda",
                         backend="nccl", timeout=900.0)
    except RuntimeError as exc:
        fail(f"phase 35: {exc}")
    for r in res:
        summary = r["summary"]
        if summary["backend"] != "nccl" or \
                summary["process_count"] != world:
            fail(f"phase 35: rank {r['rank']} ran {summary}")
    print(f"phase 35: world {world} NCCL rank(s), {res[0]['summary']}"
          + ("; one rank splits no level: the plumbing alone"
             if world == 1 else ""))

    def ms(x):
        return "-" if x is None else f"{x * 1e3:.1f}"

    for name in cases:
        r = res[0][name]
        for other in res[1:]:
            if not np.array_equal(other[name]["u"], r["u"]):
                fail(f"phase 35 {name}: rank {other['rank']} holds another "
                     "solution")
        tiers = r["tiers"]
        print(f"sharded {name} {N}^2 on mesh {r['mesh']}: sharded depth "
              f"{len(tiers)}, tiers (x, y) per level {tiers}; iterations "
              f"{r['iterations']} (one-rank {r['one_iterations']}, "
              f"single-device plain {r['ref_iterations']}), converged "
              f"{r['converged']}, max|u - u_one| {r['max_diff_one']:.3e}, "
              f"max|u - u_plain| {r['max_diff_ref']:.3e}, l2 {r.get('l2')}; "
              f"A+H launches {r['launches']} (one-rank "
              f"{r['one_launches']})"
              + (f", block {r['block_shape']} of {r['global_shape']}"
                 if "block_shape" in r else "")
              + f"; rank 0's first call {r['seconds']:.3f} s, min of "
              f"{repeats} {ms(r['best'])} ms (one-rank {ms(r['one_best'])}"
              f" ms, plain {ms(r['ref_best'])} ms, kernel path "
              f"{ms(r.get('kernel_best'))} ms) [{card}]")
        if not r["converged"] or r["iterations"] != r["one_iterations"] or \
                r["max_diff_one"] > SHARDED_ATOL:
            fail(f"phase 35 {name}: the sharded solve differs from the "
                 "single-device solve under the hook")
        needs = name in ("mixed", "adaptive")
        if any(x[name]["launches"] != x[name]["one_launches"] for x in res) \
                or (needs and not r["launches"]):
            fail(f"phase 35 {name}: launches of A and H "
                 f"{[x[name]['launches'] for x in res]}, one-rank "
                 f"{[x[name]['one_launches'] for x in res]}")
    print(f"phase 35: {time.perf_counter() - start:.1f} s")


def sharded3d_path(card, *, repeats: int = 0):
    """Phase 36: the 3D hook (``make_constrainer3d``: (x, y) blocks of
    whole z-lines) and sharded time stepping over NCCL, one rank per
    visible card, on the mesh of the whole world, backend 'auto':
    ``solve_poisson3d(mesh=)`` on poisson3d_mms_sinsinsin at N3^3 'mixed'
    and N3_REF^3 'adaptive' (tol 1e-9), the N3^3 'mixed' ``ir_solve3d``
    under ``make_constrainer3d`` alone (its hierarchy, hook and
    ``shard_inputs`` blocks made once, so its calls after the first time
    the solve and its closing gather), ``solve_heat(mesh=)`` fp32 CN on
    pure_diffusion(N) for SHARDED_HEAT_STEPS steps and
    ``solve_heat3d(mesh=)`` fp32 CN on pure_diffusion3d(N3_REF) for
    SHARDED_HEAT3D_STEPS steps. Each is held on every rank to the same call
    on a one-rank mesh (the single-device solve under the hook: equal
    iterations or steps, the solution bit for bit, the same launches of
    the smoothing kernels, E's in 3D and A's in 2D, at least one) and to
    the unhooked single-device kernel path (equal counts, within
    PATH3D_ATOL, the fp32 heat states within SHARDED_HEAT_ATOL; the N3^3
    l2 within L2_RTOL of its expected value); every rank must return the
    same solution (its digest). ``repeats`` times that many more calls of
    each (at least one of the solve alone), whose minimum is printed beside
    rank 0's first call, the one-rank and kernel paths'; one more sharded
    call of each (and one-rank call, on several cards) runs under
    torch.profiler on every rank (busy share, and the device ms per launch
    of E in 3D, of A in 2D). On one card the world is one rank and no level is split: the
    phase checks the launch, NCCL and the plumbing of the entry points."""
    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.parallel import \
        checks, launch

    start = time.perf_counter()
    world = torch.cuda.device_count()
    C = checks.Case
    cfg = {"tol": 1e-9, "backend": "auto"}
    # the plain path is phase 30's and 27-28's to time; a world of one
    # profiles its sharded call alone, which is the one-rank call
    opts = {"repeats": repeats, "digest": True, "plain": False}
    cases = {  # on the mesh of the whole world
        "mixed3d": C("frontend3d", "poisson3d_mms_sinsinsin", N3, None,
                     changes=cfg, options={"precision": "mixed",
                                           "profile": "rbgs3d", **opts}),
        "mixed3d_solve": C("sharded3d", "poisson3d_mms_sinsinsin", N3,
                           None, "mixed", changes=cfg,
                           options={**opts, "repeats": max(repeats, 1),
                                    "blocks": True, "profile": "rbgs3d"}),
        "adaptive3d": C("frontend3d", "poisson3d_mms_sinsinsin", N3_REF,
                        None, changes=cfg,
                        options={"precision": "adaptive", **opts}),
        "heat_cn": C("heat", "pure_diffusion", N, None, "float32",
                     changes={"backend": "auto"},
                     options={"t_final": SHARDED_HEAT_STEPS * 1e-4,
                              "dt": 1e-4, "profile": "smooth_kernel",
                              **opts}),
        "heat3d_cn": C("heat3d", "pure_diffusion3d", N3_REF, None, "float32",
                       changes={"backend": "auto"},
                       options={"t_final": SHARDED_HEAT3D_STEPS * 1e-3,
                                "dt": 1e-3, "profile": "rbgs3d", **opts}),
    }
    try:
        res = launch.run(checks.run_cases, world, cases, "cuda",
                         backend="nccl", timeout=900.0)
    except RuntimeError as exc:
        fail(f"phase 36: {exc}")
    for r in res:
        summary = r["summary"]
        if summary["backend"] != "nccl" or \
                summary["process_count"] != world:
            fail(f"phase 36: rank {r['rank']} ran {summary}")
    print(f"phase 36: world {world} NCCL rank(s), {res[0]['summary']}"
          + ("; one rank splits no level: the plumbing alone"
             if world == 1 else ""))

    def ms(x, per=1):
        return "-" if x is None else f"{x * 1e3 / per:.1f}"

    for name, case in cases.items():
        r = res[0][name]
        heat = case.kind in ("heat", "heat3d")
        count = "steps" if heat else "iterations"
        one = r["one_steps"] if heat else r["one_iterations"]
        per = r["steps"] if heat else 1
        kernel = "A" if case.kind == "heat" else "E"
        for other in res[1:]:
            if other[name]["u"] != r["u"]:
                fail(f"phase 36 {name}: rank {other['rank']} holds another "
                     "solution")
        print(f"sharded {name} {case.n} on mesh {r['mesh']}: sharded depth "
              f"{len(r.get('tiers', []))}, tiers {r.get('tiers')}; {count} "
              f"{r[count]} (one-rank {one}, single-device kernel path "
              f"{r['kernel_iterations']}), max|u - u_one| "
              f"{r['max_diff_one']:.3e}, max|u - u_kernel| "
              f"{r['max_diff_kernel']:.3e}, l2 {r.get('l2')}"
              + (f", gathers {r['gathers']}" if heat else "")
              + f"; {kernel} launches per rank "
              f"{[x[name]['launches'] for x in res]} (one-rank "
              f"{[x[name]['one_launches'] for x in res]}); ms per "
              f"{'step' if heat else 'solve'}: rank 0's first call "
              f"{ms(r['seconds'], per)}, min of {case.options['repeats']} "
              f"{ms(r['best'], per)} (one-rank {ms(r['one_best'], per)}, "
              f"kernel path {ms(r['kernel_best'], per)}) [{card}]")
        for key, label in (("profile", "sharded"), ("profile_one",
                                                     "one-rank")):
            for x in res:
                p = x[name].get(key)
                if p:
                    print(f"profile {name} {label}, rank {x['rank']}: wall "
                          f"{p['wall_ms']:.1f} ms, device {p['device_ms']:.1f}"
                          f" ms, busy {p['busy']:.1%}; {kernel} "
                          f"{p['kernel_launches']} launches, "
                          f"{p['kernel_ms_per_launch']:.4f} ms device per "
                          f"launch, {p['kernel_device_ms']:.1f} ms in all "
                          f"[{card}]")
                    if x is res[0]:
                        for op, op_ms, n in p["top"]:
                            print(f"  top device op {op_ms:9.2f} ms x{n:5d} "
                                  f"{op}")
        if r[count] != one or r["max_diff_one"] != 0.0 or \
                (not heat and not r["converged"]):
            fail(f"phase 36 {name}: the sharded run differs from the "
                 "single-device run under the hook")
        if r["kernel_iterations"] != r[count] or r["max_diff_kernel"] > (
                SHARDED_HEAT_ATOL if heat else PATH3D_ATOL):
            fail(f"phase 36 {name}: the sharded run differs from the "
                 "unhooked single-device kernel path")
        if any(x[name]["launches"] != x[name]["one_launches"]
               or not x[name]["launches"] for x in res):
            fail(f"phase 36 {name}: launches of {kernel} "
                 f"{[x[name]['launches'] for x in res]}, one-rank "
                 f"{[x[name]['one_launches'] for x in res]}")
        if heat and r["gathers"] != (1 if world > 1 else 0):
            fail(f"phase 36 {name}: {r['gathers']} global gathers, the "
                 "run's end makes the only one")
    for name in ("mixed3d", "mixed3d_solve"):
        l2 = res[0][name]["l2"]
        if abs(l2 / L2_3D_EXPECTED[N3] - 1) > L2_RTOL:
            fail(f"phase 36 {name}: l2 {l2:.4e}, expected "
                 f"{L2_3D_EXPECTED[N3]:.4e}")
    print(f"phase 36: {time.perf_counter() - start:.1f} s")


def support_path(mg, card, dev, main_ms):
    """Phase 37: the support layers (``validation``, ``benchmarking``,
    ``utils.timing``) on the card, backend 'auto', each run from launch
    counts reset to zero. ``main_ms`` is phase 6's kernel-path ms per
    solve, printed beside the suite's 1025^2 mixed time."""
    import tempfile

    import torch

    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import BenchmarkSuite, MultigridProfiler, suite as suite_mod
    from mixed_precision_multigrid_solvers_for_pdes_torch.utils import \
        trace_profile
    from mixed_precision_multigrid_solvers_for_pdes_torch.validation import \
        MMSValidator, PerformanceBaselines, baselines, theory

    start = time.perf_counter()
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             backend="auto")
    two_d = ("smooth_multisweep", "residual_restrict", "prolong_correct",
             "tail_vcycle")
    three_d = ("rbgs3d", "residual_restrict3d", "prolong_correct3d")

    def launched(label, got, names):
        missing = [k for k in names if got[k] <= 0]
        print(f"{label}: launches {({k: v for k, v in got.items() if v})}")
        if missing:
            fail(f"phase 37 {label}: kernels never launched: {missing}")

    def check_order(res, sizes):
        print(f"MMS {res.problem} {res.kind} {list(sizes)}: l2 "
              f"{[f'{e:.4e}' for e in res.l2_errors]}, order "
              f"{res.observed_order:.4f} (H1 {res.h1_order:.4f}), "
              f"iterations {res.iterations}, passed {res.passed}, "
              f"{res.wall_s:.2f} s [{card}]")
        if not res.passed or abs(res.observed_order - 2.0) > \
                SUPPORT_ORDER_TOL:
            fail(f"phase 37 MMS {res.kind}: order {res.observed_order:.3f} "
                 f"not within 2 +- {SUPPORT_ORDER_TOL}, or not passed")

    # 1. the 2D MMS ladder in 'mixed' (A-D on the fp32 levels above the
    # tail, D once per V-cycle)
    mms = MMSValidator(cfg, precision="mixed", device=dev)
    res, got = counted_run(lambda: mms.validate_steady(
        mg.poisson_mms_sinsin, sizes=SUPPORT_SIZES))
    check_order(res, SUPPORT_SIZES)
    launched("MMS 2D mixed", got, two_d)
    direct, got = counted_run(lambda: mg.solve_poisson(
        mg.poisson_mms_sinsin(SUPPORT_N), precision="mixed", cfg=cfg,
        device=dev))
    launched(f"solve_poisson mixed {SUPPORT_N}^2", got, two_d)
    print(f"MMS row {SUPPORT_N}^2: {res.iterations[-1]} outer steps; the "
          f"same call on the kernel path alone: {direct.iterations}")
    if res.iterations[-1] != direct.iterations or not direct.converged:
        fail(f"phase 37: the MMS row's {res.iterations[-1]} steps differ "
             f"from the kernel path's {direct.iterations}")

    # 2. the 3D MMS ladder in fp32 (E, F and G)
    mms3 = MMSValidator(cfg, precision="fp32", device=dev)
    res3, got = counted_run(lambda: mms3.validate_steady3d(
        mg.poisson3d_mms_sinsinsin, sizes=SUPPORT_SIZES3D))
    check_order(res3, SUPPORT_SIZES3D)
    launched("MMS 3D fp32", got, three_d)
    del mms, mms3, direct
    torch.cuda.empty_cache()

    # 3. the measured cycle factor on the fp32 hierarchy, kernels and plain
    prob = mg.poisson_mms_sinsin(SUPPORT_N)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    rho = {}
    for backend in ("auto", "torch"):
        out, got = counted_run(lambda: theory.measure_two_grid_factor(
            levels, cfg.replace(backend=backend)))
        rho[backend] = out["rho"]
        print(f"two-grid factor {SUPPORT_N}^2 fp32 {backend}: rho "
              f"{out['rho']:.6f}, ratios "
              f"{[f'{r:.4f}' for r in out['ratios']]}")
        if backend == "auto":
            launched("two-grid factor auto", got, ("smooth_multisweep",))
        if not out["rho"] < SUPPORT_RHO_MAX:
            fail(f"phase 37: rho {out['rho']:.4f} ({backend}) not below "
                 f"{SUPPORT_RHO_MAX}")
    if abs(rho["auto"] - rho["torch"]) > SUPPORT_RHO_ATOL:
        fail(f"phase 37: the two backends' rho differ by more than "
             f"{SUPPORT_RHO_ATOL}: {rho}")

    # 4. h-independence of the measured factor
    hind = theory.validate_h_independence(
        mg.poisson_mms_sinsin, SUPPORT_H_SIZES, cfg, dtype="float32",
        device=dev)
    print(f"h-independence fp32 {list(SUPPORT_H_SIZES)}: rhos "
          f"{ {n: round(r, 6) for n, r in hind['rhos'].items()} }, spread "
          f"{hind['spread']:.6f}, h_independent {hind['h_independent']}")
    if not hind["h_independent"]:
        fail("phase 37: the measured factor is not h-independent")

    # 5. the benchmark suite on both backends
    suite = BenchmarkSuite(mg.poisson_mms_sinsin, device=dev)
    suite.run(sizes=SUPPORT_SUITE_SIZES, precisions=("fp32", "fp64",
                                                     "mixed"),
              runs=3, backends=("auto", "torch"))
    for r in suite.records:
        print(f"suite {r.n}^2 {r.precision} {r.backend}: {r.wall_s * 1e3:.3f}"
              f" ms (std {r.std_s * 1e3:.3f}), {r.iterations} iterations "
              f"({r.rho_kind} rho {r.convergence_factor:.4f}), "
              f"{r.dof_per_s:.6e} DoF/s, l2 {r.error_l2:.4e} [{card}]")
    bad = [(r.n, r.precision, r.backend) for r in suite.records
           if not r.converged]
    if bad:
        fail(f"phase 37: suite records did not converge: {bad}")
    print(f"suite precision_speedups {suite.precision_speedups()}")
    print(f"suite backend_speedups {suite.backend_speedups()}")
    print(f"suite fp32 scaling exponent {suite.scaling_exponent('fp32'):.4f}")
    mixed = min(r.wall_s for r in suite.records if r.n == SUPPORT_N and
                r.precision == "mixed" and r.backend == "auto")
    print(f"suite {SUPPORT_N}^2 mixed auto {mixed * 1e3:.3f} ms per solve "
          f"beside phase 6's {main_ms:.3f} ms: the suite solves from zero "
          f"with no FMG start to tol 1e-8 on fp32/bf16 levels, phase 6 from "
          f"an FMG start to tol 1e-9 on fp32 levels [{card}]")
    del suite

    # 6. the baselines on the same discrete systems
    base = PerformanceBaselines(device=dev)
    for n in SUPPORT_BASE_SIZES:
        p = mg.poisson_mms_sinsin(n)
        rows = [base.run_ours(p, "mixed", runs=1),
                base.run_ours(p, "fp64", runs=1),
                base.run_scipy_direct(p, runs=1),
                base.run_scipy_cg(p, runs=1)]
        for r in rows:
            print(f"baseline {n}^2 {r.solver}: {r.wall_s * 1e3:.3f} ms, "
                  f"{r.iterations} iterations, l2 {r.error_l2:.6e} [{card}]")
        ref = rows[2].error_l2
        for r in rows[:2]:
            if abs(r.error_l2 / ref - 1) > SUPPORT_ERR_RTOL:
                fail(f"phase 37 baseline {n}^2: {r.solver} l2 "
                     f"{r.error_l2:.4e} not within {SUPPORT_ERR_RTOL:.0%} "
                     f"of scipy_spsolve's {ref:.4e}")
        if base.run_pyamg(p, runs=1) is not None or \
                base.run_petsc(p, runs=1) is not None:
            fail("phase 37: a pyamg or petsc row where neither is installed")
    t0 = time.perf_counter()
    baselines._assemble_csr(mg.poisson_mms_sinsin(513))
    print(f"_assemble_csr 513^2 host seconds "
          f"{time.perf_counter() - t0:.4f} (problem set-up included)")
    print(f"baselines complexity exponents {base.complexity_exponents()}")

    # 7. the per-stage profiler on the fp32 hierarchy (smooth: kernel A)
    prof = MultigridProfiler(levels, cfg)
    _, got = counted_run(lambda: prof.profile_level(0))
    launched(f"profiler level 0 ({SUPPORT_N}^2)", got, ("smooth_multisweep",))
    prof.profile_all()
    for key, rec in prof.records.items():
        print(f"profiler {key} ({rec['n']}^2 {rec['dtype']}): " + ", ".join(
            f"{st} {rec[st]['min_s'] * 1e3:.4f} ms "
            f"{rec[st]['gbytes_per_s']:.1f} GB/s "
            f"({rec[st]['gbytes_per_s'] * 1e9 / HBM_BYTES_PER_S:.1%})"
            for st in ("smooth", "residual", "restrict", "prolong")
            if st in rec) + f" [{card}]")
    print(f"profiler bottlenecks {prof.bottlenecks()}")

    # 8. a torch.profiler trace of one mixed solve
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with trace_profile(path):
            mg.solve_poisson(prob, precision="mixed", cfg=cfg, device=dev)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        print(f"trace_profile: {size} bytes")
        if size <= 0:
            fail("phase 37: trace_profile wrote no trace")

    # 9. the environment
    print(f"system_info {json.dumps(suite_mod.system_info())}")
    del levels, prof
    torch.cuda.empty_cache()
    print(f"phase 37: {time.perf_counter() - start:.1f} s")


def vcycle_flops(sizes, pre=2, post=2, coarse=32, update=12):
    """fp32 operations of one V(pre, post) cycle over square levels
    ``sizes``: ``update`` per smoothing update, 10 per fine residual, 12 per
    restricted node, 3 per prolonged node, ``coarse`` sweeps at the
    coarsest."""
    ops = coarse * update * (sizes[-1] - 2) ** 2
    for n, nc in zip(sizes, sizes[1:]):
        ops += ((pre + post) * update + 10 + 3) * (n - 2) ** 2 \
            + 12 * (nc - 2) ** 2
    return ops


def work(name):
    """(compulsory bytes, fp32 operations) of one call of kernel ``name``
    at its main-path shapes: each input read once, each output written
    once; the operations this call's data needs."""
    n, nc = N, (N - 1) // 2 + 1
    m, mc = N3, (N3 - 1) // 2 + 1
    tail = [129]
    while tail[-1] > 3:
        tail.append((tail[-1] - 1) // 2 + 1)
    hx = (N + 1) // 2
    return {
        "smooth_multisweep": (12 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict": (8 * n * n + 4 * nc * nc,
                              10 * (n - 2) ** 2 + 12 * (nc - 2) ** 2),
        "prolong_correct": (4 * nc * nc + 8 * n * n, 3 * (n - 2) ** 2),
        "tail_vcycle": (12 * 129 ** 2, vcycle_flops(tail)),
        "smooth_var": (32 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict_var": (28 * n * n + 4 * nc * nc,
                                  10 * (n - 2) ** 2 + 12 * (nc - 2) ** 2),
        "tail_vcycle_var": (12 * 129 ** 2 + 20 * sum(k * k for k in tail),
                            vcycle_flops(tail)),
        "rbgs3d": (12 * m ** 3, 16 * 2 * (m - 2) ** 3),
        "residual_restrict3d": (8 * m ** 3 + 4 * mc ** 3,
                                14 * (m - 2) ** 3 + 30 * (mc - 2) ** 3),
        "prolong_correct3d": (4 * mc ** 3 + 8 * m ** 3, 4 * (m - 2) ** 3),
        "smooth_planes": (12 * 4 * hx * hx, 12 * 2 * (n - 2) ** 2),
        "smooth_parity": (12 * n * n, 12 * 2 * (n - 2) ** 2),
        "probe": (12 * n * n, 5 * 2 * (n - 2) ** 2),
        "copy": (8 * n * n, n * n),
        # kernels A-D on bf16 storage: 2 bytes a node
        "smooth_multisweep_bf16": (6 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict_bf16": (4 * n * n + 2 * nc * nc,
                                   10 * (n - 2) ** 2 + 12 * (nc - 2) ** 2),
        "prolong_correct_bf16": (2 * nc * nc + 4 * n * n, 3 * (n - 2) ** 2),
        "tail_vcycle_bf16": (6 * 129 ** 2, vcycle_flops(tail)),
        # kernels E-G on bf16 storage: 2 bytes a node
        "rbgs3d_bf16": (6 * m ** 3, 16 * 2 * (m - 2) ** 3),
        "residual_restrict3d_bf16": (4 * m ** 3 + 2 * mc ** 3,
                                     14 * (m - 2) ** 3 + 30 * (mc - 2) ** 3),
        "prolong_correct3d_bf16": (2 * mc ** 3 + 4 * m ** 3,
                                   4 * (m - 2) ** 3),
        # kernels H, I, J and L on bf16 storage: 2 bytes a node (J: the
        # entry's u and f, every level's planes)
        "smooth_var_bf16": (16 * n * n, 12 * 2 * (n - 2) ** 2),
        "residual_restrict_var_bf16": (14 * n * n + 2 * nc * nc,
                                       10 * (n - 2) ** 2
                                       + 12 * (nc - 2) ** 2),
        "tail_vcycle_var_bf16": (6 * 129 ** 2
                                 + 10 * sum(k * k for k in tail),
                                 vcycle_flops(tail)),
        "smooth_parity_bf16": (6 * n * n, 12 * 2 * (n - 2) ** 2),
        # N's fp32 step: u_in, e, f in, u_out, r_lo out; 16 fp64 operations
        # a node (the update, the residual, r^2 and its sum), which the
        # bytes bound by far at either precision's peak
        "refine_step3d": (32 * m ** 3, 16 * (m - 2) ** 3),
    }[name]


def bound(name):
    """(least ms for kernel ``name``'s call at the published peaks, what
    bounds it)."""
    nbytes, flops = work(name)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _ab_3d_and_copy(mg, kb, stencil3d, ks3, kx3, dev, gen, out):
    """--against: E, F, G and u.mul_ at 513^3; the copy and torch.mul."""
    import torch

    st3 = stencil3d.make_stencil3d(mg.Grid3D(N3, N3, N3))
    u = torch.randn((N3,) * 3, generator=gen, device=dev)
    f = st3.c * torch.randn((N3,) * 3, generator=gen, device=dev)
    call = lambda: ks3.rbgs3d(st3, u, f, sweeps=2)  # noqa: E731
    out["E_ms"] = time_ms(call, reps=20)
    out["E_device_ms"] = device_ms(call, "rbgs3d")
    before = ks3.rbgs3d.launches
    call()
    out["E_launches_per_call"] = ks3.rbgs3d.launches - before
    # F at 513 -> 257 and G at 257 -> 513, and G's in-place yardstick
    call = lambda: kx3.residual_restrict3d(st3, u, f)  # noqa: E731
    out["F_ms"] = time_ms(call, reps=20)
    out["F_device_ms"] = device_ms(call, "residual_restrict3d")
    ec = torch.randn(kx3.coarse_shape3d(N3, N3, N3), generator=gen,
                     device=dev)
    call = lambda: kx3.prolong_correct3d(ec, u)  # noqa: E731
    out["G_ms"] = time_ms(call, reps=20)
    out["G_device_ms"] = device_ms(call, "prolong_correct3d")
    # E's 2-sweep call and F's 513 -> 257 call on bf16 storage
    ub, fb = u.to(torch.bfloat16), f.to(torch.bfloat16)
    out["E_bf16_device_ms"] = device_ms(
        lambda: ks3.rbgs3d(st3, ub, fb, sweeps=2), "rbgs3d")
    out["F_bf16_device_ms"] = device_ms(
        lambda: kx3.residual_restrict3d(st3, ub, fb), "residual_restrict3d")
    del ub, fb
    call = lambda: u.mul_(2.0)  # noqa: E731
    out["mul_inplace_ms"] = time_ms(call, reps=20)
    out["mul_inplace_device_ms"] = device_ms(call, "elementwise")
    del u, f, ec
    torch.cuda.empty_cache()

    for n in (N, N_COPY_HBM):
        a = torch.randn((n, n), generator=gen, device=dev)
        for name, fn, kernel in (
                ("copy", lambda: kb.copy2x(a), "copy2x"),
                ("mul", lambda: torch.mul(a, 2.0), "elementwise")):
            out[f"{name}_{n}_ms"] = time_ms(fn, reps=50)
            out[f"{name}_{n}_device_ms"] = device_ms(fn, kernel, reps=20)
        del a
    torch.cuda.empty_cache()


def solve_device_ms(run, reps: int = 3) -> float:
    """Least device time of one call of ``run`` over ``reps`` calls, each
    traced alone by torch.profiler (the card's activity only): every kernel
    and copy of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            best = min(best, us / 1e3)
    if best == float("inf"):
        fail("the profiler saw no device work in a solve, three times")
    return best


def _ab_2d(mg, ks, dev, gen, out):
    """--against: A's host and device time per call (on fp32 and bf16),
    K's, L's and D's device time, the probe's per 2-sweep call in four
    modes at 1025^2 and 513^2, and the main-path solve; H's and L's device time per 2-sweep call
    and I's per call (to the next level) on bf16 and fp32 storage at
    1025^2, 513^2 and 257^2; the wall and device ms of the fp32 jump solve
    and of phase 33's two 8-cycle 'bf16' solves (the jump problem; Poisson
    with the parity layout)."""
    import torch

    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    st2 = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                             device=dev, cfg=cfg)[0].stencil
    u2 = torch.randn((N, N), generator=gen, device=dev)
    f2 = st2.c * torch.randn((N, N), generator=gen, device=dev)
    call = lambda: ks.multisweep(st2, u2, f2, layout="direct")  # noqa: E731
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host.append((time.perf_counter() - t0) / 200)
    torch.cuda.synchronize()
    out["A_host_us_per_call"] = min(host) * 1e6
    out["A_ms"] = time_ms(call, reps=200)
    # A's and L's device time per 2-sweep call on the main path's levels
    # (K's on the planes of the 1025^2 and 513^2 levels), D's per launch
    # from 129^2 on its tail, and the main-path solve
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        planes as pln
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_planes as kp, tail as kt
    levels2 = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                 device=dev, cfg=cfg)
    for lev in levels2[:3]:
        n, stn = lev.grid.nx, lev.stencil
        un = torch.randn((n, n), generator=gen, device=dev)
        fn = stn.c * torch.randn((n, n), generator=gen, device=dev)
        out[f"A{n}_device_ms_per_call"] = device_ms_per_call(
            lambda: ks.multisweep(stn, un, fn, layout="direct"), reps=20,
            kernel="smooth_kernel")
        out[f"L{n}_device_ms_per_call"] = device_ms_per_call(
            lambda: ks.multisweep_parity(stn, un, fn), reps=20,
            kernel="parity_kernel")
        # A on bf16 u and f, beside fp32
        ub, fb = un.to(torch.bfloat16), fn.to(torch.bfloat16)
        out[f"A{n}_bf16_device_ms_per_call"] = device_ms_per_call(
            lambda: ks.multisweep(stn, ub, fb, layout="direct"), reps=20,
            kernel="smooth_kernel")
        if n in (N, 513):   # K on the planes of the same field
            up, fp = pln.split_field(un), pln.split_field(fn)
            call = lambda: kp.multisweep_planes(  # noqa: E731
                stn, up, fp, nx=n, ny=n)
            before = kp.multisweep_planes.launches
            call()
            out[f"K{n}_launches_per_call"] = (kp.multisweep_planes.launches
                                              - before)
            out[f"K{n}_device_ms_per_call"] = device_ms_per_call(call,
                                                                 reps=20)
    # the probe's 2-sweep call in every mode at 1025^2 and 513^2 (the parent
    # launched once per colour update)
    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb
    for n in (N, 513):
        up_, fp_ = kb.fields(n, dev, seed=n)
        for mode in ("roll", "sub", "lane", "none"):
            call = lambda: kb.probe(up_, fp_, mode=mode)  # noqa: E731
            before = kb.probe.launches
            call()
            out[f"probe_{mode}_{n}_device_ms_per_call"] = device_ms_per_call(
                call, reps=20, kernel="probe",
                launches=kb.probe.launches - before)
        del up_, fp_
    tail = [lev for lev in levels2 if lev.grid.nx <= 129]
    sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                   for lev in tail]
    ud = torch.zeros(shapes[0], device=dev)
    fd = sts[0].c * torch.randn(shapes[0], generator=gen, device=dev)
    call = lambda: kt.tail_vcycle(  # noqa: E731
        sts, ud, fd, shapes=shapes, pre=cfg.pre_sweeps, post=cfg.post_sweeps,
        omega=cfg.omega, method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
        symmetric=cfg.symmetric)
    out["D_ms"] = time_ms(call, reps=50)
    out["D_device_ms"] = device_ms(call, "tail_vcycle", reps=20)
    f2 = prob.rhs(torch.float64, dev)
    u0 = prob.initial_guess(torch.float64, dev)
    walls = []
    for _ in range(6):   # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = mg.ir_solve(levels2, f2, u0, cfg, inner_cycles=2,
                              max_outer=100, use_fmg=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["solve2d_ms"] = min(walls[1:]) * 1e3
    out["solve2d_iterations"] = int(info["iterations"])
    del levels2, un, fn

    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_var as ksv, transfer as kx
    jump = mg.jump_coefficient_problem(N_VAR, 1e3)
    for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        hj = mg.build_hierarchy(jump.grid, jump.spec, a=jump.a,
                                policy=mg.policy(label), device=dev)
        hp = mg.build_hierarchy(prob.grid, prob.spec,
                                policy=mg.policy(label), device=dev)
        for lj, lp in zip(hj[:VAR_UPPER_LEVELS], hp[:VAR_UPPER_LEVELS]):
            n = lj.grid.nx
            uh = torch.randn((n, n), generator=gen, device=dev).to(dt)
            fh = (1e3 * torch.randn((n, n), generator=gen,
                                    device=dev)).to(dt)
            fl = (lp.stencil.c * torch.randn((n, n), generator=gen,
                                             device=dev)).to(dt)
            out[f"H{n}_{label}_device_ms_per_call"] = device_ms_per_call(
                lambda: ksv.multisweep_var(lj.stencil, uh, fh, sweeps=2),
                reps=20)
            out[f"L{n}_{label}_device_ms_per_call"] = device_ms_per_call(
                lambda: ks.multisweep_parity(lp.stencil, uh, fl), reps=20)
            # I from this level to the next (fc in the next level's dtype)
            out[f"I{n}_{label}_device_ms_per_call"] = device_ms_per_call(
                lambda: kx.residual_restrict_var(lj.stencil, uh, fh,
                                                 out_dtype=dt), reps=20)
        del hj, hp
    # the fp32 jump solve (I's 90 launches among the rest)
    run = lambda: mg.solve_poisson(  # noqa: E731
        jump, precision="fp32", cfg=cfg, device=dev)
    run()  # warm-up
    out["solve_jump_fp32_ms"] = best_ms(run, reps=5)
    out["solve_jump_fp32_device_ms"] = solve_device_ms(run)
    cfg8 = cfg.replace(max_iterations=BF16_VAR_CYCLES)
    saved = ks.PARITY_DEFAULT
    try:
        for name, problem, parity in (("jump_bf16", jump, False),
                                      ("poisson_bf16_parity", prob, True)):
            ks.PARITY_DEFAULT = parity
            run = lambda: mg.solve_poisson(  # noqa: E731
                problem, precision="bf16", cfg=cfg8, device=dev)
            run()  # warm-up
            out[f"solve_{name}_ms"] = best_ms(run, reps=5)
            out[f"solve_{name}_device_ms"] = solve_device_ms(run)
    finally:
        ks.PARITY_DEFAULT = saved
    torch.cuda.empty_cache()


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def a_registers(log: str) -> dict:
    """Registers and spills of A's 2-sweep RB-GS kernel at each tile on
    every storage it compiles (u, f, out: f fp32, B bf16), as
    {"A_regs_<TX>x<TY>_<storage>": "<registers>r <stores>/<loads> B spill"}."""
    out = {}
    for name, (regs, st, ld) in ptxas_report(log).items():
        m = re.search(r"smooth_kernelILi(\d+)ELi(\d+)ELi2ELb0E(\w*?)EEv",
                      name)
        if m:
            types = re.sub(r"S\d*_|13__nv_bfloat16", "B", m.group(3))
            out[f"A_regs_{m.group(1)}x{m.group(2)}_{types}"] = \
                f"{regs}r {st}/{ld} B spill"
    return dict(sorted(out.items()))


def ab_set(tree: str, only_2d: bool = False) -> dict:
    """One measurement set of --against, on the package under ``tree``
    (with ``only_2d``, its 2D Poisson part alone)."""
    sys.path.insert(0, tree)
    import torch

    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.benchmarking \
        import kernel_microbench as kb
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops import \
        stencil3d
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, smooth as ks, smooth3d as ks3, transfer3d as kx3

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(mg.__file__)))
    if os.path.realpath(pkg_root) != os.path.realpath(tree):
        fail(f"--against: imported the package from {pkg_root}, not {tree}")
    dev = torch.device("cuda", 0)
    out = a_registers(_build.library().log)
    gen = torch.Generator(device=dev).manual_seed(11)

    if not only_2d:
        _ab_3d_and_copy(mg, kb, stencil3d, ks3, kx3, dev, gen, out)
    _ab_2d(mg, ks, dev, gen, out)
    if only_2d:
        return out

    # H's 2-sweep call at 1025^2 and J from 129^2 on the jump hierarchy,
    # and the varcoef and jump solves
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import smooth_var as ksv, tail as kt
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    jump = mg.jump_coefficient_problem(N_VAR, 1e3)
    levels = mg.build_hierarchy(jump.grid, jump.spec, a=jump.a, device=dev,
                                cfg=cfg)
    st = levels[0].stencil
    uh = torch.randn((N_VAR, N_VAR), generator=gen, device=dev)
    fh = 1e3 * torch.randn((N_VAR, N_VAR), generator=gen, device=dev)
    call = lambda: ksv.multisweep_var(st, uh, fh, sweeps=2)  # noqa: E731
    out["H_ms"] = time_ms(call, reps=50)
    out["H_device_ms_per_call"] = device_ms_per_call(call, reps=20)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host.append((time.perf_counter() - t0) / 200)
    torch.cuda.synchronize()
    out["H_host_us_per_call"] = min(host) * 1e6
    before = ksv.multisweep_var.launches
    call()
    out["H_launches_per_call"] = ksv.multisweep_var.launches - before
    for lev in levels[1:VAR_UPPER_LEVELS]:
        n, stn = lev.grid.nx, lev.stencil
        un = torch.randn((n, n), generator=gen, device=dev)
        fn = 1e3 * torch.randn((n, n), generator=gen, device=dev)
        out[f"H{n}_device_ms_per_call"] = device_ms_per_call(
            lambda: ksv.multisweep_var(stn, un, fn, sweeps=2), reps=20)
    tail = [lev for lev in levels if lev.grid.nx <= 129]
    sts, shapes = [lev.stencil for lev in tail], [lev.grid.shape
                                                   for lev in tail]
    uj = torch.zeros(shapes[0], device=dev)
    fj = 1e3 * torch.randn(shapes[0], generator=gen, device=dev)
    call = lambda: kt.tail_vcycle_var(  # noqa: E731
        sts, uj, fj, shapes=shapes, pre=cfg.pre_sweeps, post=cfg.post_sweeps,
        omega=cfg.omega, method=cfg.smoother, coarse_sweeps=cfg.coarse_sweeps,
        symmetric=cfg.symmetric)
    out["J_ms"] = time_ms(call, reps=50)
    out["J_device_ms"] = device_ms(call, "tail_var", reps=20)
    del uh, fh, levels
    for name, prob in (("varcoef", mg.variable_coefficient_mms(N_VAR)),
                       ("jump", jump)):
        solves = [mg.solve_poisson(prob, precision="fp32", cfg=cfg,
                                   device=dev) for _ in range(4)]
        out[f"solve_{name}_ms"] = min(r.solve_time for r in solves[1:]) * 1e3
        out[f"solve_{name}_iterations"] = int(solves[-1].iterations)
    torch.cuda.empty_cache()

    cfg3 = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    levels3 = mg.build_hierarchy3d(mg.Grid3D(N3, N3, N3), dtype="float32",
                                   device=dev, cfg=cfg3)
    u0 = torch.zeros((N3,) * 3, dtype=torch.float64, device=dev)
    rhs = [rhs3d(levels3, i, 0, 2, dev) for i in range(2)]
    mg.ir_solve3d(levels3, rhs[0], u0, cfg3, inner_cycles=2)  # warm-up
    ks3.rbgs3d.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, info = mg.ir_solve3d(levels3, rhs[0], u0, cfg3, inner_cycles=2)
    torch.cuda.synchronize()
    out["solve3d_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["solve3d_E_launches"] = ks3.rbgs3d.launches
    out["solve3d_iterations"] = int(info["iterations"])
    best = float("inf")
    for _ in range(3):
        total = 0.0
        for fr in rhs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mg.ir_solve3d(levels3, fr, u0, cfg3, inner_cycles=2)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        best = min(best, total / len(rhs))
    out["solve3d_ms"] = best * 1e3
    del levels3, rhs
    torch.cuda.empty_cache()
    # the BF16_3D_ITERS-cycle 'bf16' solve: every level on E-G in bf16
    bcfg = cfg3.replace(max_iterations=BF16_3D_ITERS)
    levels3 = mg.build_hierarchy3d(mg.Grid3D(N3, N3, N3),
                                   policy=mg.policy("bf16"), device=dev,
                                   cfg=cfg3)
    fb = rhs3d(levels3, 0, 0, 1, dev).to(torch.bfloat16)
    ub = torch.zeros_like(fb)
    mg.mg_solve3d(levels3, fb, ub, bcfg)  # warm-up
    out["solve3d_bf16_ms"] = best_ms(
        lambda: mg.mg_solve3d(levels3, fb, ub, bcfg), reps=3)
    return out


def against(others, only_2d: bool = False) -> int:
    """--against DIR [DIR ...]: sets on each DIR and on this checkout, in
    turns (DIR, this, this, DIR for each)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sets = []
    for other in map(os.path.abspath, others):
        name = os.path.basename(other.rstrip("/"))
        for label, tree in ((name, other), ("this", here), ("this", here),
                            (name, other)):
            cmd = [sys.executable, os.path.abspath(__file__), "--ab-set",
                   tree] + (["--2d"] if only_2d else [])
            run = subprocess.run(cmd, cwd=tree, capture_output=True,
                                 text=True, timeout=900)
            if run.returncode != 0:
                print(run.stdout[-2000:] + run.stderr[-4000:],
                      file=sys.stderr)
                fail(f"--against: the set on {tree} failed")
            rec = json.loads(run.stdout.strip().splitlines()[-1])
            sets.append(rec | {"tree": label})
            print(json.dumps(sets[-1]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    labels = list(dict.fromkeys(r["tree"] for r in sets))
    for key in sets[0]:
        if key != "tree":
            print(f"{key}: " + " ".join(
                f"{lab} {[r[key] for r in sets if r['tree'] == lab]}"
                for lab in labels) + f" [{card}]")
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    only_2d = "--2d" in argv
    args = [a for a in argv if a != "--2d"]
    if len(args) == 2 and args[0] == "--ab-set":
        print(json.dumps(ab_set(args[1], only_2d)))
        return 0
    if len(args) >= 2 and args[0] == "--against":
        return against(args[1:], only_2d)
    if argv:
        print("usage: python3 chip_smoke.py [--against DIR [DIR ...] "
              "[--2d]]", file=sys.stderr)
        return 2
    import mixed_precision_multigrid_solvers_for_pdes_torch as mg
    from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels \
        import _build, refine3d as kr3, smooth as ks, smooth3d as ks3, \
        tail as kt, transfer as kx, transfer3d as kx3

    card = host_report()
    print(card)

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {'nvcc' if lib.built else 'reused'} "
          f"{lib.build_seconds:.2f} s (first use {time.perf_counter() - t0:.2f}"
          f" s incl. load) -> {lib.path}")
    print(lib.log.strip())
    print("A's 2-sweep RB-GS kernels (u, f, out: f fp32, B bf16): "
          + json.dumps(a_registers(lib.log)))

    dev = torch.device("cuda", 0)
    prob = mg.poisson_mms_sinsin(N)
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                             max_iterations=40, backend="auto")
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                device=dev, cfg=cfg)
    errs, times = kernel_phase(levels, cfg, dev)

    wrappers = {"smooth_multisweep": ks.multisweep,
                "residual_restrict": kx.residual_restrict,
                "prolong_correct": kx.prolong_correct,
                "tail_vcycle": kt.tail_vcycle}
    f = prob.rhs(torch.float64, dev)
    for w in wrappers.values():
        w.launches = 0
    u_k, info_k = solve(mg, levels, prob, cfg, f, dev)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    err_k = prob.error_norms(u_k)
    print(f"solve auto: iterations {info_k['iterations']} converged "
          f"{info_k['converged']} history {info_k['history'].tolist()} "
          f"l2 {err_k['l2']:.6e} linf {err_k['linf']:.6e} "
          f"launches {launches}")
    if tuple(u_k.shape) != (N, N) or not torch.isfinite(u_k).all():
        fail("solution is misshapen or not finite")
    if not info_k["converged"] or info_k["iterations"] != ITERS_EXPECTED:
        fail(f"expected convergence in {ITERS_EXPECTED} outer steps")
    if abs(err_k["l2"] / L2_EXPECTED - 1) > L2_RTOL:
        fail(f"l2 error {err_k['l2']:.4e} not within {L2_RTOL:.0%} of "
             f"{L2_EXPECTED:.3e}")
    missing = [name for name, c in launches.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    a_plan, d_plan = main_path_launches(levels, cfg, info_k["iterations"])
    print(f"main path: A {launches['smooth_multisweep']} launches (plan "
          f"{a_plan}), D {launches['tail_vcycle']} (plan {d_plan})")
    if (launches["smooth_multisweep"], launches["tail_vcycle"]) != \
            (a_plan, d_plan):
        fail(f"A and D launches {launches} differ from the plan "
             f"({a_plan}, {d_plan})")

    cfg_plain = cfg.replace(backend="torch")
    u_p, info_p = solve(mg, levels, prob, cfg_plain, f, dev)
    torch.cuda.synchronize()
    du = (u_k - u_p).abs().max().item()
    print(f"solve torch: iterations {info_p['iterations']} history "
          f"{info_p['history'].tolist()} max|u_auto - u_torch| {du:.3e}")
    if info_p["iterations"] != info_k["iterations"] or du > PATH_ATOL:
        fail(f"kernel and plain paths disagree (iterations "
             f"{info_k['iterations']} vs {info_p['iterations']}, "
             f"max diff {du:.3e} > {PATH_ATOL})")

    dofs = (N - 2) ** 2
    t_k = timed_solves(mg, levels, prob, cfg, dev)
    t_p = timed_solves(mg, levels, prob, cfg_plain, dev)
    for label, t in (("kernels (auto)", t_k), ("plain (torch)", t_p)):
        print(f"solve time {label}: {t * 1e3:.3f} ms per solve, "
              f"{dofs / t:.6e} DoF/s [{card}]")
    u0 = prob.initial_guess(torch.float64, dev)
    profile_solve(f"main path {N}^2", lambda: mg.ir_solve(
        levels, f, u0, cfg, inner_cycles=2, max_outer=100, use_fmg=True),
        wrappers)
    clocks("phase 6's device readings")
    dev_ms = main_path_device(levels, card)

    # ---- parity paths: kernels K, L and M -------------------------------
    errs_par, times_par, library, copy_rate, dev_ms_par = \
        kernel_phase_parity(levels, card, dev)
    dev_ms.update(dev_ms_par)
    errs.update(errs_par)
    times.update(times_par)
    launches["smooth_parity"] = parity_main_path(mg, levels, prob, cfg, f,
                                                 u_k, card, dev)
    del u_k, u_p, f, levels
    torch.cuda.empty_cache()
    launches.update(microbench_path(card))
    launches["smooth_planes"] = plane_path(mg, card, dev)
    torch.cuda.empty_cache()

    # ---- variable-coefficient and Robin path -----------------------------
    errs_var, times_var, launches_var = var_path(mg, card, dev)
    for name, err in errs_var.items():
        errs[name] = max(errs.get(name, 0.0), err)
    times.update(times_var)
    launches.update(launches_var)
    for n, (ms, per_call) in smooth_var_per_call(mg, card, dev).items():
        dev_ms[("smooth_var", n)] = ms
        if per_call != 1:
            fail(f"H made {per_call} launches in a 2-sweep call at {n}^2, "
                 "its plan is 1")
    print(f"H device ms per 2-sweep call at {N_VAR}^2: "
          f"{dev_ms[('smooth_var', N_VAR)]:.4f} (target <= {H_TARGET_MS}) "
          f"[{card}]")
    dev_ms[("tail_vcycle_var", 129)] = tail_var_entries(mg, card, dev)[129]
    dev_ms[("residual_restrict_var", N_VAR)] = var_transfer_device(mg, card,
                                                                   dev)
    torch.cuda.empty_cache()

    # ---- 3D path ----------------------------------------------------------
    errs3, times3, dev_ms3 = kernel_phase3d(dev, card)
    errs.update(errs3)
    times.update(times3)
    dev_ms.update(dev_ms3)
    errs3, times3, dev_ms3 = refine_phase3d(dev, card)
    errs.update(errs3)
    times.update(times3)
    dev_ms.update(dev_ms3)
    wrappers3 = {"rbgs3d": ks3.rbgs3d,
                 "residual_restrict3d": kx3.residual_restrict3d,
                 "prolong_correct3d": kx3.prolong_correct3d,
                 "refine_step3d": kr3.refine_step3d}
    solve3d(mg, N3_REF, "auto", dev)
    for w in wrappers3.values():
        w.launches = 0
    res_k, peak_k = solve3d(mg, N3, "auto", dev)
    launches3 = {name: w.launches for name, w in wrappers3.items()}
    print(f"solve3d {N3}^3 auto launches {launches3}")
    missing = [name for name, c in launches3.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the 3D path: {missing}")
    per_cycle, transfers = launches_per_cycle(mg, ks3, N3, dev)
    cycles = res_k.iterations * IR_INNER_CYCLES
    e_plan = cycles * per_cycle
    print(f"E launches per {N3}^3 solve: {launches3['rbgs3d']} (its plan: "
          f"{res_k.iterations} outer steps x {IR_INNER_CYCLES} cycles x "
          f"{per_cycle} = {e_plan}); F and G: one per call, "
          f"{cycles} cycles x {transfers} levels = {cycles * transfers}")
    if launches3["rbgs3d"] != e_plan:
        fail(f"E made {launches3['rbgs3d']} launches in the {N3}^3 solve, "
             f"its plan {e_plan}")
    for name in ("residual_restrict3d", "prolong_correct3d"):
        if launches3[name] != cycles * transfers:
            fail(f"{name} made {launches3[name]} launches in the {N3}^3 "
                 f"solve, one per call is {cycles * transfers}")
    print(f"N launches per {N3}^3 solve: {launches3['refine_step3d']} "
          f"(its plan: the start and {res_k.iterations} outer steps)")
    if launches3["refine_step3d"] != 1 + res_k.iterations:
        fail(f"refine_step3d made {launches3['refine_step3d']} launches in "
             f"the {N3}^3 solve, its plan {1 + res_k.iterations}")
    launches.update(launches3)
    res_p, peak_p = solve3d(mg, N3, "torch", dev)
    du = (res_k.u - res_p.u).abs().max().item()
    print(f"solve3d {N3}^3: max|u_auto - u_torch| {du:.3e}; peak memory "
          f"kernel path {peak_k / 2**30:.3f} GiB, plain path "
          f"{peak_p / 2**30:.3f} GiB")
    if res_p.iterations != res_k.iterations or du > PATH3D_ATOL:
        fail(f"3D kernel and plain paths disagree (iterations "
             f"{res_k.iterations} vs {res_p.iterations}, max diff "
             f"{du:.3e} > {PATH3D_ATOL})")
    del res_k, res_p
    torch.cuda.empty_cache()

    cfg3 = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                              backend="auto")
    levels3 = mg.build_hierarchy3d(mg.Grid3D(N3, N3, N3), dtype="float32",
                                   device=dev, cfg=cfg3)
    dofs3 = (N3 - 2) ** 3
    t3_k = timed_solves3d(mg, levels3, cfg3, K3, dev)
    t3_p = timed_solves3d(mg, levels3, cfg3.replace(backend="torch"),
                          K3_PLAIN, dev)
    for label, t in (("kernels (auto)", t3_k), ("plain (torch)", t3_p)):
        print(f"solve3d time {N3}^3 {label}: {t * 1e3:.3f} ms per solve, "
              f"{dofs3 / t:.6e} DoF/s [{card}]")
    f3 = rhs3d(levels3, 0, 0, 1, dev)
    u03 = torch.zeros_like(f3)
    profile_solve(f"3D {N3}^3", lambda: mg.ir_solve3d(
        levels3, f3, u03, cfg3, inner_cycles=2), wrappers3)
    del levels3, f3, u03
    torch.cuda.empty_cache()

    # ---- the rest of the 2D operator: phases 20-22 -----------------------
    for name, err in operator_path(mg, card, dev).items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()

    # ---- precision staging and domains: phases 23-24 ---------------------
    errs_bf, times_bf, dev_ms_bf, launches_bf = precision_path(mg, card, dev)
    errs.update(errs_bf)
    times.update(times_bf)
    dev_ms.update(dev_ms_bf)
    launches.update(launches_bf)
    domain_path(mg, card, dev)
    torch.cuda.empty_cache()

    # ---- Galerkin coarsening and the Krylov solvers: phases 25-26 --------
    galerkin_path(mg, card, dev)
    krylov_path(mg, card, dev)

    # ---- the heat equations: phases 27-28 --------------------------------
    for name, err in heat_kernel_checks(mg, dev).items():
        errs[name] = max(errs.get(name, 0.0), err)
    heat_path(mg, card, dev)
    heat3d_path(mg, card, dev)

    # ---- the rest of 3D: phases 29-31 ------------------------------------
    errs_b3, times_b3, dev_ms_b3 = kernel_phase3d_bf16(mg, card, dev)
    errs.update(errs_b3)
    times.update(times_b3)
    dev_ms.update(dev_ms_b3)
    launches.update(precision3d_path(mg, card, dev))
    operator3d_path(mg, card, dev)

    # ---- bf16 in H, I, J and L, the 2D varcoef precisions, halo_solve:
    # ---- phases 32-34
    errs_v, times_v, dev_ms_v = kernel_phase_var_bf16(mg, card, dev)
    for name, err in errs_v.items():
        errs[name] = max(errs.get(name, 0.0), err)
    times.update(times_v)
    dev_ms.update(dev_ms_v)
    launches.update(var_precision_path(mg, card, dev))
    torch.cuda.empty_cache()
    halo_path(card)

    # ---- the GSPMD path: phase 35 ----------------------------------------
    sharded_path(card)

    # ---- 3D and time-stepping sharding: phase 36 --------------------------
    sharded3d_path(card)

    # ---- the support layers: phase 37 -------------------------------------
    support_path(mg, card, dev, t_k * 1e3)

    sources = {"smooth_multisweep": ("csrc/smooth.cu", "smooth.py:290"),
               "residual_restrict": ("csrc/transfer.cu", "transfer.py:262"),
               "prolong_correct": ("csrc/transfer.cu", "transfer.py:488"),
               "tail_vcycle": ("csrc/tail.cu", "tail.py:170"),
               "smooth_var": ("csrc/smooth_var.cu", "smooth.py:290"),
               "residual_restrict_var": ("csrc/transfer_var.cu",
                                         "transfer.py:262"),
               "tail_vcycle_var": ("csrc/tail_var.cu", "tail.py:122"),
               "rbgs3d": ("csrc/smooth3d.cu", "smooth3d.py:178"),
               "residual_restrict3d": ("csrc/transfer3d.cu",
                                       "transfer3d.py:194"),
               "prolong_correct3d": ("csrc/transfer3d.cu",
                                     "transfer3d.py:342"),
               "smooth_planes": ("csrc/smooth_parity.cu",
                                 "smooth_planes.py:225"),
               "smooth_parity": ("csrc/smooth_parity.cu", "smooth.py:119"),
               "probe": ("csrc/probes.cu",
                         "scripts/kernel_microbench.py:108"),
               "copy": ("csrc/probes.cu", "scripts/kernel_microbench.py:123"),
               "smooth_multisweep_bf16": ("csrc/smooth.cu", "smooth.py:290"),
               "residual_restrict_bf16": ("csrc/transfer.cu",
                                          "transfer.py:262"),
               "prolong_correct_bf16": ("csrc/transfer.cu",
                                        "transfer.py:488"),
               "tail_vcycle_bf16": ("csrc/tail.cu", "tail.py:170"),
               "rbgs3d_bf16": ("csrc/smooth3d.cu", "smooth3d.py:178"),
               "residual_restrict3d_bf16": ("csrc/transfer3d.cu",
                                            "transfer3d.py:194"),
               "prolong_correct3d_bf16": ("csrc/transfer3d.cu",
                                          "transfer3d.py:342"),
               "smooth_var_bf16": ("csrc/smooth_var.cu", "smooth.py:290"),
               "residual_restrict_var_bf16": ("csrc/transfer_var.cu",
                                              "transfer.py:262"),
               "tail_vcycle_var_bf16": ("csrc/tail_var.cu", "tail.py:122"),
               "smooth_parity_bf16": ("csrc/smooth_parity.cu",
                                      "smooth.py:119"),
               # N replaces no Pallas kernel: _ir3_jit leaves it to XLA
               "refine_step3d": ("csrc/refine3d.cu", None)}
    main_n = {"smooth_multisweep": 1025, "residual_restrict": 1025,
              "prolong_correct": 1025, "tail_vcycle": 129,
              "smooth_var": N_VAR, "residual_restrict_var": N_VAR,
              "tail_vcycle_var": 129, "rbgs3d": N3,
              "residual_restrict3d": N3, "prolong_correct3d": N3,
              "smooth_planes": N, "smooth_parity": N, "probe": N, "copy": N,
              "smooth_multisweep_bf16": N, "residual_restrict_bf16": N,
              "prolong_correct_bf16": N, "tail_vcycle_bf16": 129,
              "rbgs3d_bf16": N3, "residual_restrict3d_bf16": N3,
              "prolong_correct3d_bf16": N3, "smooth_var_bf16": N_VAR,
              "residual_restrict_var_bf16": N_VAR,
              "tail_vcycle_var_bf16": 129, "smooth_parity_bf16": N,
              "refine_step3d": N3}
    timed = {"probe": "probe_roll"}  # the record times the 5-point probe
    record = []
    for name, (src, rep) in sources.items():
        key = (timed.get(name, name), main_n[name])
        bound_ms, bound_by = bound(name)
        ms = times[key][0]
        record.append({
            "name": name, "route": "cuda", "source": f"{PKG}/{src}",
            "replaces": rep if rep is None or rep.startswith("scripts/")
            else f"{TPU_PKG}/{rep}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": times[key][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library.get(key),
            "device_ms": dev_ms.get(key)})
        nbytes = work(name)[0]
        print(f"bound {name}: {nbytes / 1e6:.3f} MB, {bound_ms:.5f} ms at "
              f"3.35 TB/s ({bound_by}), {nbytes / copy_rate * 1e3:.5f} ms at "
              f"the measured copy rate; kernel {ms:.4f} ms, the bound is "
              f"{bound_ms / ms:.1%} of it [{card}]")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
