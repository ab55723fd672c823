#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — compile every CUDA kernel of the training paths, one nvcc
                per source, all started together, and print each kernel's
                registers and spills;
  3. kernels  — each kernel against its plain PyTorch version on the card
                (TF32 off): the fused Metropolis sweep at the flagship
                shapes (10x10, C=16^3, k=3, M=2048, trained fixture params)
                and at the tfim16 shape (N=16, C=(12,12), k=5), and its
                recompute forward bitwise the same on a permuted batch, a
                sub-batch and a longer batch (several walkers share a
                block); the fused
                GCNN forward at the j1j2_8x8_gcnn shapes (W=64, L=3,
                lncosh, complex, B=2048), at the depth-12 fixture
                (W=80, L=12, selu, residual, B=512, trained params), with
                real params, with a B1 character and at a batch that fits
                no block size; complex lncosh at weight scales 0.15 and 0.3,
                where rounding may cross its branch cuts, held to twice the
                disagreement of a second plain version (the Karatsuba
                model) plus 0.5% of the configurations; K2's bf16 route
                (wgmma bf16 with A from registers, the weights streamed by
                TMA bulk copies through a ring of shared-memory stages, each
                complex layer one real GEMM over [[wr, wi], [-wi, wr]])
                against its plain bf16 version (BF16_TOL) at the
                j1j2_8x8_gcnn_r2 shape (W=80, L=8, selu, residual, B=2048
                and 777), at the depth-12 fixture, with real lncosh params,
                and on log psi through FusedLogPsi (A1 spin-flip +1, B1
                spin-flip -1), with a second plain version (the CPU's
                summation order) printed beside it as the witness;
  4. main     — the training paths through ``qmcnn_tpu_torch.train.train``,
                each with the launch counters zeroed just before it and
                read just after it:
                configs/heis10x10_sr.yaml at full width warm-started from
                runs/ab_cnn_float32.csv.params.npz (5 steps after the
                config's 100 thermalization sweeps; the tail energy must sit
                within 0.01/site of the -0.6705/site the JAX run that wrote
                the fixture reached; the sweep kernel serves the sweeps,
                the refreshes and E_loc, at the expected count per step),
                a few steps of configs/tfim16_sgd.yaml (flip moves, 1D, the
                ED check, the same count), and configs/j1j2_8x8_gcnn.yaml
                at full width (M=1024, exchange_anti, minSR; 3 steps after 20
                thermalization sweeps; the fused GCNN forward must run on
                every evaluation, at the expected count per step, and match
                its plain version on the trained params); then the
                depth-12 snapshot runs/j1j2_8x8_d12_fix.csv.params.npz in
                its own architecture (M=512), whose tail energy must sit
                within 0.01/site of the -0.497679/site its JAX run reached;
                configs/j1j2_8x8_gcnn_r2.yaml (bf16 end to end) at full
                width, 3 steps after 20 thermalization sweeps with a
                checkpoint every step, then train() again to step 4, which
                must resume at step 3 from a checkpoint bitwise equal to
                the first run's state (every evaluation forward on K2's
                bf16 route, at the expected count; K2 f32 and K1 0); the
                depth-12 snapshot again in bf16 (its run's own dtype), and
                its E_loc on one set of walkers through both K2 routes
                (mean difference under 3 binned stderr); heis10x10_sr in
                bf16 from runs/ab_cnn_bfloat16.csv.params.npz (tail within
                0.01/site of -0.670410; K1 0); the complex CNN: the
                tfim12_h2 snapshot (tail within 1e-3 of the ED energy) and
                configs/j1j2_8x8_complex.yaml at full width (3 steps);
                frustrated lattices and SPRING: the gcnn_r2 leg again with
                the round-2 SPRING run's overrides (sr.momentum 0.9, shift
                0.001, lr 0.025; runs/j1j2_8x8_spring.csv.meta.json), its
                K2 bf16 counts as the plain leg's, SPRING's carried delta
                finite, non-zero and restored bitwise with the checkpoint;
                the tri6x3_j1j2 snapshot (phase prior, Jastrow amplitude
                and phase; 100 sweeps, 10 steps) within 0.01/site of its
                JAX run and 2% of the port's ED; the kagome GCNN and
                PhaseNet snapshots (SPRING, 100 sweeps, 4 steps) within
                0.01/site of their JAX runs with |E_im| under 3 binned
                stderr; tri6x6_tgcnn at full width from a fresh init (W =
                96, radius-2 star; 10 sweeps, 2 steps), printing its auto
                chunk size; K1 and K2 launched 0 times on the prior and D6
                legs;
                the last ansatz families (``families_phase``): the ViT
                snapshots in their runs' configs (4x4, 100 sweeps and 10
                steps, within 0.01/site of -0.528248 and 1e-2 of the
                port's ED; 8x8, 25 sweeps and 4 steps, within 0.01/site of
                -0.497066, |E_im| under 3 binned stderr), the kagome ARNN
                snapshot with the direct sampler (4 steps, within 0.01/site
                of -0.390776, acceptance exactly 1), tfim16_arnn and
                j1j2_4x4_arnn (PixelCNN, S^z = 0) fresh with Sum |psi|^2
                over all 65,536 / 12,870 configurations within 1e-4 of 1
                and one step's sampled energy within 4 stderr of the
                enumerated one, heis40_arnn (5 steps, every sample at
                S^z = 0), both ViT configs fresh (2 steps), an RBM, a
                translation- and point-group-averaged CNN and an XYZ chain
                (a few steps, finite energies); K1 and K2 0 on every leg;
                excited states, EMA, sectors, (1 + alpha H) and tempering
                (``excited_phase``): the 8x8 J1-J2 first excited state by
                deflation (runs/j1j2_8x8_excited_defl.csv: the bf16 d12
                GCNN, M = 1024, SPRING, EMA 0.998) against the d12 ground
                state, 100 sweeps, 4 steps checkpointed, resumed to step 5
                (tail within 0.01/site of -0.485990, overlap in
                (0.02, 0.6), the EMA written to .ema.npz and restored
                bitwise, every evaluation forward, the frozen state's and
                its draw included, on K2's bf16 route at the expected
                count, K2 f32 and K1 0); the 4x4 one (20 steps, within
                0.01/site of -0.499191 and 3% of the sector-ED E1
                -8.13899, |overlap| < 0.05); the kagome (1 + alpha H)
                PhaseNet snapshot with its alpha (3 steps, within 0.01/site
                of -0.431008 and 2% of ED); the untied RBM in the (pi, pi)
                sector (3 steps, E_q finite and printed beside the JAX
                run's -0.131644, the weight 1/64, one step on the card
                equal to the CPU's on the same walkers); heis10x10_sr from
                the fixture tempered at (1.0, 0.7, 0.45) (6,144 rows, 20
                sweeps, 3 steps: the b = 1 tail within 0.01/site of
                -0.6705, each pair's swap acceptance in (0, 1), K1's
                recompute forward at the expected count and its fused sweep
                unused); each leg's step split;
                the measurement entry point (``measure_phase``;
                ``qmcnn_tpu_torch.measure``): (a) the heis10x10_sr fixture
                in its run's config (M = 2048, 4 samples, --total-spin
                --dimer --sector-momentum 0,0 --renyi2 half --renyi2 50:100
                --renyi2 0:10 --sma --lanczos-step --fidelity-ckpt the bf16
                sibling run's snapshot) with K1 serving every sweep and
                forward at the expected count (within 0.01/site of the JAX
                run, magnetization 0, the S(q) peak at (pi, pi), the NN
                S.S within 0.01 of E/site / 2, the q = 0 sector weight
                within 1e-4 of 1 and its energy within 1e-4 |E| of E; half
                and 50:100 per sample within 1e-6, S_2 > 0; C_t(1) and
                C_t(10) within 0.01, the SMA gap at (pi, pi); the Lanczos
                step valid, its gain at most sqrt(k2); the fidelity in
                (0, 1.05] and exactly 1 with itself); (b) the bf16-trained
                gcnn_r2 snapshot p15b measured in f32 with --sma on K2's
                f32 route at the expected count (4 samples; against the
                JAX f32 reports runs/j1j2_8x8_p15_measure_f32.json:
                E/site within max(0.002, 5 sigma), the S(q) peak, NN S.S
                within 0.005, staggered m2 within 10%; and
                runs/j1j2_8x8_sma.json: each C_t within 0.005, the gap at
                index 36 and within 10%); (c) ``python -m
                qmcnn_tpu_torch.measure --ema --chirality`` on the kagome
                PhaseNet snapshot (the EMA's report within 0.01/site of
                JAX's and its S(q) peak, a finite chirality, no kernel);
                (c') the CLI's --lanczos-step on that run's final params at
                M = 1024 against runs/kagome3x3_r3_lanczos_diag.json (the
                step valid, E/site within max(5 sigma, 0.002), the Lanczos
                E/site within max(5 jackknife errors, 0.002)); (d) leg
                (a)'s measurement in 2 gloo ranks on cuda:0 against 1 rank,
                4 samples (walkers bitwise, pooled Lanczos and sector
                arrays bitwise or within rtol 1e-6, the report within 1e-5
                of its scale, K1 per rank exact), then under torchrun with
                NCCL; each leg's split per sample;
                the dynamics entry points (``dynamics_phase``;
                ``qmcnn_tpu_torch.evolve`` and ``analyze``): (a) the
                chain-12 real-time quench h 2 -> 1.2 through the CLI (the
                complex CNN [12, 12], k = 5, from runs/tfim12_h2's
                snapshot, full sum, dense, 362 steps of 0.005; no kernel)
                against runs/tvmc_chain12_quench.csv (row 1's energy
                within 2e-4 relative and sx within 5e-4) and the exact
                evolution of the same state, which that TPU-written run
                leaves by 1e-2 (row 1 to its float64 value, sx and
                szsz_nn within 1e-3 to t = 1.0), the drift to t = 1.5
                under 0.5%, C(0) = 0.25; and ``analyze
                --quench-spectrum`` on its rows against the JAX history
                cut to as many (the six
                modes whose JAX omega is within 4% of the exact one,
                within 4%); (b) tfim16_sgd at full width in imaginary
                time over all 65,536 states (40 Heun steps, dense at
                diag_shift 1e-2) with
                K1 serving every evaluation forward at the expected count
                (8 per step), held first to the plain model at 65,536 and
                1,048,576 rows and on step 1 to the CPU; the energy never
                rising; (c) the 8x8 TFIM MC quench h 3 -> 1.5 from
                runs/tfim8x8_h3w2g (20 steps, no kernel) against rows
                1-20 of runs/tvmc_tfim8x8_quench_w2f.csv (means within
                0.01); (d) heis10x10_sr in imaginary time from the fixture
                (MC, minSR, 5 steps) on K1's fused sweep and recompute
                forward at the expected count, within 0.01/site of
                -0.6705; K2 0 on every leg; each leg's split per step;
                the tooling (``tooling_phase``): (b) ``python -m
                qmcnn_tpu_torch.supervise`` on heis10x10_sr from the fixture
                (6 steps, a checkpoint every 2), its child SIGSTOPped once
                .events holds ``save_end 2``: the supervisor kills it at 20
                s of stale heartbeat, attempt 2 resumes at step 2 and ends
                with rc 0, its final params bitwise those of the same run
                uninterrupted in this process (K1 at its expected count),
                the five event names, the last heartbeat at 6; while it
                runs, (a) ``python -m qmcnn_tpu_torch.scan`` over
                tfim16_sgd at full width (h = 3.0, 2.0, 1.5, 100 steps a
                point; ED rel_err < 0.15, cold then warm starts, each
                point's npz loading, K1 at 3 x its expected count, printed
                by the child) and (g) native ED built here (tfim16 and the
                4x4 Heisenberg within 1e-9 of the sparse ED, the 24-site
                chain's S^z = 0 sector within 1e-8 of the Bethe ansatz);
                then (c) the checked step (``run.checkify``): heis10x10_sr
                2 steps on K1 and j1j2_8x8_gcnn 1 step on K2 f32 bitwise
                the unchecked runs with the same launches, a NaN in K1's
                packed weights raising from K1's wrapper, an out-of-bounds
                index_select on the card raising before its launch with K1
                bitwise right after it; (d) a torch.profiler trace of 2
                heis10x10_sr steps (the ten largest kernels, the device
                idle share, K1 with its counted launches; the gzipped
                chrome trace under ``TOOLING_OUT``); (e) MFU
                of K1's flagship sweep, K2 f32 at the E_loc chunk and a
                whole heis10x10_sr step (``utils/mfu``); (f) the 8x8 ViT
                snapshot with the bf16 trunk (E_loc in bf16 within 3 binned
                stderr of f32 on one set of walkers, 4 bf16 steps, K1 = K2
                = 0, its step split);
                then walker sharding: the same code in 2 ranks spawned on
                cuda:0 (this script with ``--sharded-rank``; a gloo group,
                since NCCL refuses two ranks on one card) against the
                1-rank run in this process, each leg's counters zeroed just
                before and read just after it on every rank: heis10x10_sr
                at full width from the fixture (100 thermalization sweeps, 2
                pcg steps), j1j2_8x8_gcnn at full width with the gather and
                the ring minSR assembly (2 steps each) and the
                MULTICHIP_r05.json dryrun's shape (pcg and cg): walkers
                bitwise equal to the 1-rank run's through step 1's
                sampling, params bitwise equal across ranks after every
                step and within tolerance of the 1-rank run, K1 / K2
                launches per rank as ``expected_launches`` gives for the
                rank's walkers, each rank's heis10x10_sr step split; the
                tempered heis10x10_sr and the 4x4 E1 deflation legs too
                (20 sweeps, 2 steps; the EMA, SPRING's carry and the
                overlap bitwise equal across ranks), and the tempered leg
                after 4 sweeps, whose pcg solve moves by reduction order
                (``pcg_split_gate``: each step's update within a quarter
                of the 1-rank run's largest entry, cosine >= 0.99, norm
                ratio within 10%); then
                the CLI under ``torch.distributed.run`` with NCCL, one rank
                per card shown (at most 4), 3 steps;
  5. timings  — CUDA-event times of each kernel, its plain version and its
                bounds at the main path's shapes (``bound_ms``: the least
                work as f32-accurate 3xTF32 on the tensor cores, or the
                bytes; ``fp32_bound_ms``: the same work on the FP32 cores):
                the sweep kernel per sweep and as the recompute forward of
                the heis10x10_sr E_loc batch (411,648 configurations) beside
                the cuDNN model on the same batch (its log psi within rtol
                1e-5), the kernels' blocks, K2's bf16 route at the
                j1j2_8x8_gcnn_r2 E_loc chunk and sweep shapes and at the
                depth-12 fixture beside its plain version, its bf16
                tensor-core bound and K2's f32 route at the same shapes, and
                the per-phase split of a training step of each path (the
                program's spans, ``utils/profiling.step_split``), the
                SPRING, tri6x6_tgcnn,
                kagome3x3_kgcnn, ViT 8x8, kagome ARNN and heis40_arnn legs
                included (the direct sampler's ms per site beside the
                ARNNs), and the excited phase's legs (sample, E_loc, the
                deflation's forwards, gradient, SR, update);
  6. report   — one JSON line of kernel records (the sweep, K2's f32 route,
                K2's bf16 route with the SPRING leg's launches beside the
                plain leg's; each with its launches in the measurement
                phase, and K1's and K2 f32's in the tooling phase; the sharded and measurement phases printed their
                own ``{"sharded": ...}`` and ``{"measure": ...}`` lines),
                the card line, and the final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --measure`` (``--excited``, ``--dynamics``,
``--tooling``) runs only the kernels' build and the measurement (excited,
dynamics, tooling) phase.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
CUDA device or without the ``qmcnn_tpu_torch`` package beside it.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "runs" / "ab_cnn_float32.csv.params.npz"
E_SITE_FIXTURE = -0.6705  # the JAX run that wrote the fixture (BASELINE.md)
GCNN_CONFIG = ROOT / "configs" / "j1j2_8x8_gcnn.yaml"
D12_FIXTURE = ROOT / "runs" / "j1j2_8x8_d12_fix.csv.params.npz"
#: final_energy_tail / 64 of the JAX run that wrote the depth-12 snapshot
#: (runs/j1j2_8x8_d12_fix.csv.meta.json)
E_SITE_D12 = -0.497679
#: the snapshot's architecture (its meta.json), in float32
D12_MODEL = ("model.channels=[" + ",".join(["10"] * 12) + "]",
             "model.activation=selu", "model.init_mode=fan_in",
             "model.param_scale=1.0", "model.residual=true")
#: the HBM rate (H100 SXM data sheet; its FLOP rates are in utils/mfu.py)
HBM_BYTES_PER_S = 3.35e12
#: the bf16 hero config (bf16 end to end, K2's bf16 route)
GCNN_R2_CONFIG = ROOT / "configs" / "j1j2_8x8_gcnn_r2.yaml"
#: the bf16 CNN snapshot and its JAX run's final_energy_tail / 100
#: (runs/ab_cnn_bfloat16.csv.meta.json)
CNN_BF16_FIXTURE = ROOT / "runs" / "ab_cnn_bfloat16.csv.params.npz"
E_SITE_CNN_BF16 = -0.670410
#: the complex CNN snapshot of the N = 12 TFIM chain at h = 2, its config
#: (from the JAX run's meta.json) and its e_exact (ED)
TFIM12_META = ROOT / "runs" / "tfim12_h2.csv.meta.json"
TFIM12_FIXTURE = ROOT / "runs" / "tfim12_h2.csv.params.npz"
E_TFIM12_ED = -25.525138
#: K2's bf16 route against its plain bf16 version: S_g within BF16_TOL of
#: (1 + the configuration's largest |S_g|). Both sides round at the same
#: points, so what is left is the f32 summation order now and then flipping
#: one bf16 rounding (2^-8 relative) of an activation, which later layers
#: carry on: measured on the H100 up to 1.7e-4 at depth 8 (fan_in init) and
#: 5.7e-3 on the depth-12 snapshot, whose trained layers amplify such
#: flips (PERF.md); two plain versions that sum in other orders (cuDNN and
#: oneDNN) differ as much, printed beside it as the witness
BF16_TOL = 1e-2
#: the round-2 SPRING run (runs/j1j2_8x8_spring.csv.meta.json): the gcnn_r2
#: config with these overrides
SPRING_OVERRIDES = ("sr.momentum=0.9", "sr.diag_shift0=0.001",
                    "sr.diag_shift_decay=1.0", "sr.diag_shift_min=0.001",
                    "optimizer.lr=0.025", "optimizer.lr_min_ratio=0.1")
#: the frustrated-lattice snapshots of the JAX package and their runs' tail
#: E/site: tri6x3_j1j2 (phase prior and Jastrow amplitude and phase on the
#: complex CNN; 18 sites, within ED range), the kagome GCNN and PhaseNet
#: (both trained with SPRING)
TRI_META = ROOT / "runs" / "tri6x3_j1j2_jphase.csv.meta.json"
TRI_FIXTURE = ROOT / "runs" / "tri6x3_j1j2_jphase.csv.params.npz"
E_SITE_TRI = -0.53379
KGCNN_META = ROOT / "runs" / "kagome3x3_r3_kgcnn.csv.meta.json"
KGCNN_FIXTURE = ROOT / "runs" / "kagome3x3_r3_kgcnn.csv.params.npz"
E_SITE_KGCNN = -0.39368
PHASENET_META = ROOT / "runs" / "kagome3x3_r3_phasenet.csv.meta.json"
PHASENET_FIXTURE = ROOT / "runs" / "kagome3x3_r3_phasenet.csv.params.npz"
E_SITE_PHASENET = -0.42255
#: E/site: the ViT snapshots (4x4 on the patch torus 2x2, 6 blocks x 48; 8x8
#: on 4x4, 8 blocks x 64) and the kagome ARNN (MADE 3 x 256, complex, the
#: sqrt3 phase prior, the direct sampler) — each JAX run's
#: final_energy_tail / N (their meta.json)
VIT4_META = ROOT / "runs" / "j1j2_4x4_vit_cap.csv.meta.json"
VIT4_FIXTURE = ROOT / "runs" / "j1j2_4x4_vit_cap.csv.params.npz"
E_SITE_VIT4 = -0.528248
VIT8_META = ROOT / "runs" / "j1j2_8x8_vit_cap.csv.meta.json"
VIT8_FIXTURE = ROOT / "runs" / "j1j2_8x8_vit_cap.csv.params.npz"
E_SITE_VIT8 = -0.497066
KARNN_META = ROOT / "runs" / "kagome3x3_r3_arnn.csv.meta.json"
KARNN_FIXTURE = ROOT / "runs" / "kagome3x3_r3_arnn.csv.params.npz"
E_SITE_KARNN = -0.390776
#: the excited-state, Lanczos and sector snapshots of the JAX package, each
#: in its run's config (meta.json), with the run's final_energy_tail / N:
#: the 8x8 J1-J2 first excited state by deflation (c = 2, EMA 0.998,
#: SPRING) of the bf16 depth-12 residual GCNN against the d12 ground state
#: (scripts/r5_pipeline3.sh), the 4x4 one of the complex CNN 16^3 against
#: its ground state, with the sector-ED E1 (BASELINE.md), the kagome
#: PhaseNet with phi = (1 + alpha H) psi against kagome-27 ED
#: (scripts/r5_pipeline2.sh), and the untied complex RBM in the
#: q = (pi, pi) sector (scripts/r5_pipeline6.sh)
DEFL8_META = ROOT / "runs" / "j1j2_8x8_excited_defl.csv.meta.json"
DEFL8_FIXTURE = ROOT / "runs" / "j1j2_8x8_excited_defl.csv.params.npz"
DEFL8_FROZEN = ROOT / "runs" / "j1j2_8x8_d12_refine.csv.params.npz"
E_SITE_DEFL8 = -0.485990
DEFL4_META = ROOT / "runs" / "j1j2_4x4_excited_defl.csv.meta.json"
DEFL4_FIXTURE = ROOT / "runs" / "j1j2_4x4_excited_defl.csv.params.npz"
DEFL4_FROZEN = ROOT / "runs" / "j1j2_4x4_ground.csv.params.npz"
E_SITE_DEFL4 = -0.499191
E1_4X4_ED = -8.13899
LANCZOS_META = ROOT / "runs" / "kagome3x3_r5_lanczos_refine.csv.meta.json"
LANCZOS_FIXTURE = ROOT / "runs" / "kagome3x3_r5_lanczos_refine.csv.params.npz"
E_SITE_LANCZOS = -0.431008
E_SITE_KAGOME_ED = -0.4362779624
SECTOR_META = ROOT / "runs" / "j1j2_8x8_sector_pipi.csv.meta.json"
SECTOR_FIXTURE = ROOT / "runs" / "j1j2_8x8_sector_pipi.csv.params.npz"
E_SITE_SECTOR = -0.131644
#: the tempering ladder of the kagome A/B (BASELINE.md)
TEMPER_BETAS = (1.0, 0.7, 0.45)
#: the measurement legs: the JAX runs behind the heis10x10_sr fixture
#: (its meta.json), the bf16 gcnn_r2 snapshot p15b (its run's config in its
#: meta.json) with the JAX measure report of it in f32, and the kagome
#: PhaseNet run with its EMA and the JAX measure --ema report of it; the
#: samples each leg takes (cut from 8 / 10 / 10 when slice 12's flags
#: doubled the phase, and (a), (b) from 6 to 4 when slice 13's dynamics
#: phase took the script to 948 s, to keep it well under 1,000 s)
FIXTURE_META = ROOT / "runs" / "ab_cnn_float32.csv.meta.json"
P15B_META = ROOT / "runs" / "j1j2_8x8_p15b.csv.meta.json"
P15B_FIXTURE = ROOT / "runs" / "j1j2_8x8_p15b_params.npz"
P15B_REPORT = ROOT / "runs" / "j1j2_8x8_p15_measure_f32.json"
KAGOME_EXT_META = ROOT / "runs" / "kagome3x3_r3_phasenet_ext.csv.meta.json"
KAGOME_EXT_FIXTURE = (ROOT / "runs"
                      / "kagome3x3_r3_phasenet_ext.csv.params.npz")
KAGOME_EXT_REPORT = ROOT / "runs" / "kagome3x3_r3_phasenet_ext_ema.json"
MEASURE_SAMPLES = {"cnn": 4, "gcnn": 4, "kagome": 6}
#: leg (a)'s Renyi-2 regions: half the sites, its complement, a row
MEASURE_REGIONS = ("half", "50:100", "0:10")
#: the JAX SMA reports: another heis10x10_sr state (printed beside leg
#: (a)), and p15b, leg (b)'s snapshot
HEIS_SMA_REPORT = ROOT / "runs" / "heis10x10_sma.json"
P15B_SMA_REPORT = ROOT / "runs" / "j1j2_8x8_sma.json"
#: leg (c')'s JAX Lanczos-step diagnostic of the kagome PhaseNet run
#: (scripts/r4_pipeline3.sh, arm I) and the run's CSV
KAGOME_LANCZOS_REPORT = ROOT / "runs" / "kagome3x3_r3_lanczos_diag.json"
KAGOME_EXT_CSV = ROOT / "runs" / "kagome3x3_r3_phasenet_ext.csv"
#: the dynamics legs: tfim16_sgd (the imaginary-time flow at full width
#: from its fresh init, and with scripts/r2_pipeline37.sh's overrides the
#: chain-12 real-time quench from the h = 2 ground state, against the JAX
#: run's CSVs and spectrum); the 8x8 TFIM quench from the h = 3 state of
#: scripts/r3_pipeline3g.sh against rows 1-20 of its run's CSV
TFIM16_CONFIG = ROOT / "configs" / "tfim16_sgd.yaml"
CHAIN12_OVERRIDES = ("lattice.shape=[12]", "hamiltonian.h=1.2",
                     "model.complex_params=true")
CHAIN12_QUENCH = ROOT / "runs" / "tvmc_chain12_quench.csv"
CHAIN12_CORR = ROOT / "runs" / "tvmc_chain12_corr.csv"
CHAIN12_SPECTRUM = ROOT / "runs" / "chain12_spectrum.json"
#: the JAX chain-12 run's finite steps (it went non-finite at t = 1.815)
CHAIN12_STEPS = 362
TFIM8X8_META = ROOT / "runs" / "tfim8x8_h3w2g.csv.meta.json"
TFIM8X8_FIXTURE = ROOT / "runs" / "tfim8x8_h3w2g.csv.params.npz"
TFIM8X8_QUENCH = ROOT / "runs" / "tvmc_tfim8x8_quench_w2f.csv"
#: the ED ground energy of the N = 16, h = J TFIM chain
E_TFIM16_ED = -20.404594


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_case(name, params, lattice, m, move, seed, device):
    """Walkers, noise and the reference log psi for one sweep check."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import sweep_reference
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    n = lattice.n_sites
    s = init_walkers(prng_key(seed), m, n,
                     sector="sz0" if move == "exchange" else None,
                     device=device)
    lp = sweep_reference(params, s, torch.zeros(m, device=device),
                         lattice_shape=lattice.shape, n_props=0)[1]
    bonds = lattice.nn_bonds if move == "exchange" else None
    n_choices = n if move == "flip" else len(bonds)
    return dict(name=name, params=params, lattice=lattice, s=s, lp=lp,
                bonds=bonds, move=move, n_choices=n_choices,
                ids=torch.arange(m, device=device), key=prng_key(seed + 1))


def compare_kernel(case, n_sweeps: int = 2) -> dict:
    """Kernel vs plain version on the card: recompute mode, then an
    n_sweeps run with injected noise. Returns max abs error of log psi."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import (metropolis_sweep,
                                                          sweep_reference)
    from qmcnn_tpu_torch.sampler.metropolis import sweep_noise

    p, lat, s, lp = case["params"], case["lattice"], case["s"], case["lp"]
    kw = dict(lattice_shape=lat.shape, move=case["move"], bonds=case["bonds"])
    _, lp_k, _ = metropolis_sweep(p, s, lp, n_props=0, **kw)
    torch.cuda.synchronize()
    a, b = lp_k.double().cpu().numpy(), lp.double().cpu().numpy()
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    max_abs = float(np.max(np.abs(a - b)))
    print(f"  {case['name']}: recompute max rel err {rel:.3e} "
          f"(max abs {max_abs:.3e}, |log psi| ~ {np.abs(b).mean():.3f})")
    check(rel <= 1e-5, f"{case['name']} recompute rel err {rel} > 1e-5")

    n_props = n_sweeps * lat.n_sites
    noise = sweep_noise(case["key"], case["ids"], n_props, case["n_choices"])
    s_k, lp_kt, acc_k = metropolis_sweep(p, s, lp, n_props=n_props,
                                         noise=noise, **kw)
    s_r, lp_rt, acc_r = sweep_reference(p, s, lp, n_props=n_props,
                                        noise=noise, **kw)
    torch.cuda.synchronize()
    differ = float((s_k != s_r).any(dim=1).float().mean())
    lp_re = sweep_reference(p, s_k, lp_kt, n_props=0, **kw)[1]
    track = float(((lp_kt - lp_re).abs() / lp_re.abs()).max())
    acc = float(acc_k.float().mean()) / n_props
    print(f"  {case['name']} {case['move']} {n_sweeps} sweeps: walkers "
          f"ending in a different s {differ:.5f}, tracked-vs-recomputed "
          f"log psi max rel {track:.3e}, accept {acc:.4f} (plain "
          f"{float(acc_r.float().mean()) / n_props:.4f})")
    check(differ <= 1e-3, f"{case['name']}: {differ} of walkers differ")
    check(track <= 1e-4, f"{case['name']}: tracked log psi off by {track}")
    check(0.0 < acc < 1.0, f"{case['name']}: accept rate {acc}")
    if case["move"] == "exchange":
        sz = s_k.sum(dim=1)
        check(bool((sz == s.sum(dim=1)).all()), "S^z not conserved")
    return {"max_abs_err": max_abs}


def check_position_invariance(case) -> None:
    """The recompute forward gives a configuration's log psi bitwise the
    same in any slot of a block and at any batch size: a permuted batch, a
    sub-batch and a batch three configurations longer give the same bits."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep

    p, lat, s = case["params"], case["lattice"], case["s"]
    zeros = torch.zeros(s.shape[0] + 3, device=s.device)

    def recompute(x):
        return metropolis_sweep(p, x, zeros[:x.shape[0]],
                                lattice_shape=lat.shape, n_props=0)[1]

    full = recompute(s)
    perm = torch.randperm(s.shape[0], generator=torch.Generator().manual_seed(
        0)).to(s.device)
    results = {"permuted": torch.equal(recompute(s[perm]), full[perm]),
               "sub-batch": torch.equal(recompute(s[3:8]), full[3:8]),
               "longer batch": torch.equal(
                   recompute(torch.cat([s[:3], s]))[3:], full)}
    print(f"  {case['name']} {case['move']}: recompute bitwise equal "
          f"({', '.join(f'{k} {v}' for k, v in results.items())})")
    check(all(results.values()), f"{case['name']}: log psi depends on the "
          f"slot or the batch size: {results}")


def cnn_model(params, lattice):
    """The LogPsiCNN of a plain real CNN's params (channels and kernel read
    from them), on the params' device."""
    from qmcnn_tpu_torch.kernels.metropolis_sweep import conv_layers
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN

    layers = conv_layers(params, lattice.shape)
    model = LogPsiCNN(lattice.shape,
                      channels=[int(k.shape[-1]) for k, _ in layers],
                      kernel_size=tuple(layers[0][0].shape[:-2]))
    return model.to(layers[0][0].device)


def bounds(flop: float, n_bytes: float):
    """(bound ms, 'operations' | 'bytes', FP32-core bound ms): the least
    time of f32-accurate work on the tensor cores (TF32_PASSES TF32 passes
    of ``flop`` at the dense TF32 peak) or of the bytes at the memory rate,
    whichever is larger, and the same with ``flop`` on the FP32 cores."""
    from qmcnn_tpu_torch.utils.mfu import (H100_FP32_CORE_FLOPS,
                                           H100_TF32_FLOPS, TF32_PASSES)

    tc_ms = TF32_PASSES * flop / H100_TF32_FLOPS * 1e3
    fp32_ms = flop / H100_FP32_CORE_FLOPS * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(tc_ms, bytes_ms), "operations" if tc_ms >= bytes_ms
            else "bytes", max(fp32_ms, bytes_ms))


def time_sweep(case, card: str) -> dict:
    """Kernel, plain version and torch sampler ms per sweep, and the
    bounds."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import (metropolis_sweep,
                                                          sweep_reference)
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.ops.cplx import C
    from qmcnn_tpu_torch.sampler.metropolis import (MetropolisSampler,
                                                    WalkerState, sweep_noise)
    from qmcnn_tpu_torch.utils.mfu import (H100_TF32_FLOPS, TF32_PASSES,
                                           forward_flop)

    p, lat, s, lp = case["params"], case["lattice"], case["s"], case["lp"]
    m, n = s.shape
    kw = dict(lattice_shape=lat.shape, move=case["move"], bonds=case["bonds"])
    noise = sweep_noise(case["key"], case["ids"], n, case["n_choices"])
    ms = cuda_ms(lambda: metropolis_sweep(p, s, lp, n_props=n, noise=noise,
                                          **kw), reps=10)
    plain_ms = cuda_ms(lambda: sweep_reference(p, s, lp, n_props=n,
                                               noise=noise, **kw), reps=2)
    model = cnn_model(p, lat)
    sampler = MetropolisSampler(lambda q, x: log_psi_apply(model, q, x),
                                n_sites=n, move=case["move"],
                                bonds=case["bonds"], backend="torch")
    zeros = torch.zeros(m, dtype=torch.int32, device=s.device)
    state = WalkerState(s, C(lp, torch.zeros_like(lp)), zeros, zeros)
    torch_ms = cuda_ms(lambda: sampler.sample(p, state, case["key"],
                                              case["ids"], 1, noise=noise),
                       reps=2)
    flop = m * n * forward_flop(p, n)
    n_bytes = 4 * (2 * m * n + 3 * m + 3 * n * m
                   + sum(v.numel() for v in p.values()))
    bound_ms, bound_by, fp32_ms = bounds(flop, n_bytes)
    print(f"  {case['name']} ({card}): kernel {ms:.4f} ms/sweep, plain "
          f"version {plain_ms:.4f} ms/sweep, torch sampler {torch_ms:.4f} "
          f"ms/sweep, bound {bound_ms:.4f} ms ({flop:.3e} FLOP x "
          f"{TF32_PASSES} at {H100_TF32_FLOPS:.3g} TF32 FLOP/s, {bound_by}); "
          f"FP32-core bound {fp32_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "torch_sampler_ms": torch_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fp32_bound_ms": fp32_ms}


def recompute_rel_err(params, lattice, batch: int, seed: int = 31):
    """The sweep kernel's recompute forward (``FusedCNNLogPsi``) against the
    cuDNN model (TF32 off; the plain version of the recompute mode) on
    ``batch`` S^z = 0 configurations: (max relative error of log psi, the
    configurations, the fused forward, the model)."""
    import torch
    from qmcnn_tpu_torch.kernels.metropolis_sweep import FusedCNNLogPsi
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    x = init_walkers(prng_key(seed), batch, lattice.n_sites, sector="sz0",
                     device="cuda")
    model = cnn_model(params, lattice)
    fused = FusedCNNLogPsi(lattice_shape=lattice.shape)
    with torch.no_grad():
        got = fused(params, x).re.double()
        want = log_psi_apply(model, params, x).re.double()
    rel = float(((got - want).abs() / want.abs()).max())
    return rel, x, fused, model


def time_e_loc_batch(params, lattice, batch: int, card: str) -> dict:
    """The sweep kernel's recompute forward (``FusedCNNLogPsi``, the
    evaluation forward of E_loc) at the E_loc batch of heis10x10_sr against
    the cuDNN model (TF32 off; the plain version of the recompute mode) on
    the same configurations: log psi within rtol 1e-5, both times, and the
    bounds (configurations read once, log psi written once)."""
    import torch
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.utils.mfu import TF32_PASSES, forward_flop

    n = lattice.n_sites
    rel, x, fused, model = recompute_rel_err(params, lattice, batch)
    ms = cuda_ms(lambda: fused(params, x), reps=5)
    with torch.no_grad():
        cudnn_ms = cuda_ms(lambda: log_psi_apply(model, params, x), reps=5)
    flop = batch * forward_flop(params, n)
    n_bytes = 4 * (batch * n + batch + sum(v.numel() for v in params.values()))
    bound_ms, bound_by, fp32_ms = bounds(flop, n_bytes)
    print(f"  recompute forward at the E_loc batch B={batch} ({card}): kernel "
          f"{ms:.4f} ms, cuDNN model (TF32 off) {cudnn_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flop:.3e} FLOP x {TF32_PASSES}, {bound_by}) "
          f"= {100 * bound_ms / ms:.1f}% of it; FP32-core bound "
          f"{fp32_ms:.4f} ms = {100 * fp32_ms / ms:.1f}%; log psi max rel "
          f"err vs cuDNN {rel:.3e}")
    check(rel <= 1e-5, f"recompute forward at B={batch}: rel err {rel}")
    return {"ms": ms, "cudnn_ms": cudnn_ms, "bound_ms": bound_ms,
            "fp32_bound_ms": fp32_ms, "max_rel_err": rel}


def compacted_rows(ham, x):
    """The connected rows of walkers ``x`` under ``ham`` that carry a
    matrix element (``mask`` set): the batch E_loc hands its forward
    (``ops/local_energy.connected_log_psi``), of a size the walkers set."""
    s_prime, _, mask = ham.connected_batch(x)
    return s_prime.reshape(-1, x.shape[1])[mask.reshape(-1)]


def compacted_e_loc_checks(flagship, lattice, r2_kw: dict, dev) -> None:
    """The kernels at the compacted E_loc batches the main path runs: K1's
    recompute forward on the rows with an element of 2,048 S^z = 0 walkers
    of heis10x10_sr against the cuDNN model (TF32 off) within rtol 1e-5
    (:func:`time_e_loc_batch`'s tolerance); K2's bf16 and f32 routes on
    those of a 256-walker gcnn_r2 E_loc chunk (the 8x8 J1-J2 at J2 = 0.5)
    and their spin flips, S_g against the plain versions (bf16 within
    BF16_TOL, f32 within the p15b snapshot's 1e-3), and the f32 evaluation
    forward's log psi (A1, spin-flip +1) against the plain model as
    :func:`compare_gcnn_log_psi` holds it. Every row is held."""
    import torch
    from qmcnn_tpu_torch.kernels.gcnn_forward import FusedLogPsi
    from qmcnn_tpu_torch.kernels.metropolis_sweep import FusedCNNLogPsi
    from qmcnn_tpu_torch.lattice import square
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN, SpinFlipSymmetrized
    from qmcnn_tpu_torch.ops.hamiltonians import Heisenberg
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    x = init_walkers(prng_key(61), 2048, lattice.n_sites, sector="sz0",
                     device=dev)
    rows = compacted_rows(Heisenberg(lattice, j=1.0, marshall=True), x)
    fused = FusedCNNLogPsi(lattice_shape=lattice.shape)
    with torch.no_grad():
        got = fused(flagship, rows).re.double()
        want = log_psi_apply(cnn_model(flagship, lattice), flagship,
                             rows).re.double()
    rel = float(((got - want).abs() / want.abs()).max())
    print(f"  K1 recompute at the compacted E_loc batch of heis10x10_sr: "
          f"{rows.shape[0]} of {2048 * 200} rows, log psi max rel err vs "
          f"cuDNN {rel:.3e}")
    check(rel <= 1e-5, f"K1 recompute at the compacted batch "
          f"B={rows.shape[0]}: rel err {rel}")
    del x, rows, got, want

    model = SpinFlipSymmetrized(LogPsiGCNN(**r2_kw), 1)
    params, ws, walkers, kw = gcnn_case(r2_kw, 256, 62, dev, model=model)
    rows = compacted_rows(Heisenberg(square(8), j=1.0, j2=0.5,
                                     marshall=True), walkers)
    both = torch.cat((rows, -rows))
    label = f"gcnn_r2 compacted E_loc chunk ({rows.shape[0]} of {256 * 256}"
    compare_gcnn_bf16(f"{label} rows and their flips)", ws, both, kw)
    compare_gcnn(f"{label} rows and their flips), f32", ws, both, kw, 1e-3)
    fused_kw = {k: v for k, v in r2_kw.items()
                if k not in ("param_scale", "init_mode")}
    with torch.no_grad():
        compare_gcnn_log_psi(f"{label} rows), f32 log psi, A1, spin-flip +1",
                             model, params, rows,
                             dict(fused_kw, kernel_size=3, spin_flip_sector=1),
                             amplitudes=False)


def step_split(cfg, state, card: str, label: str, vmc=None,
               n_steps: int = 3) -> dict:
    """Per-phase time of ``n_steps`` training steps of ``VMC.step`` after
    one warm-up, read from the program's spans (``utils/profiling``: each
    phase's CUDA events), in ms per step, with ``vmc`` (None: built from
    ``cfg``)."""
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.utils.profiling import step_split as split

    if vmc is None:
        vmc, _, _ = build(cfg, device="cuda")
    totals = split(vmc, state, n_steps)
    parts = ", ".join(f"{k} {v:.2f}" for k, v in totals.items())
    print(f"  {label} step ({card}): {sum(totals.values()):.2f} ms = "
          f"{parts} ms (SR {vmc.sr.solver if vmc.sr else 'off'})")
    return totals


# ---------------------------------------------------------------------------
# the fused GCNN forward
# ---------------------------------------------------------------------------

def gcnn_bound(ws, hw: int, width: int, n_layers: int, batch: int):
    """(bound ms, 'operations' | 'bytes', FP32-core bound ms, FLOP) of
    :func:`bounds`, with bytes = x read once, weights once, S_g written
    once."""
    from qmcnn_tpu_torch.utils.mfu import gcnn_flop

    cplx = ws.lift_im is not None
    flop = gcnn_flop(hw, width, n_layers, cplx, batch)
    n_bytes = 4 * (batch * hw + batch * 16
                   + sum(w.numel() for w in ws if w is not None))
    return (*bounds(flop, n_bytes), flop)


def gcnn_case(model_kw: dict, batch: int, seed: int, device, params=None,
              model=None):
    """Params (unless given, a bias-perturbed fresh init of ``model``,
    default the bare LogPsiGCNN: zero biases and an even lncosh would make
    the s -> -s pairing degenerate), the expanded weights and S^z = 0 spins
    for one kernel check."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    shape = model_kw["lattice_shape"]
    if params is None:
        model = model or LogPsiGCNN(**model_kw)
        params = model.init(seed, device=device)
        gen = torch.Generator().manual_seed(seed + 1)
        params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(device)
                  if "bias" in k else v for k, v in params.items()}
    prefix = ("params/inner/" if any("/inner/" in k for k in params)
              else "params/")
    ws = k2.expand_gcnn_params(params, 3, model_kw["complex_params"], prefix)
    x = init_walkers(prng_key(seed + 2), batch, shape[0] * shape[1],
                     sector="sz0", device=device)
    kw = dict(lattice_shape=shape, channels=tuple(model_kw["channels"]),
              kernel_size=3, activation=model_kw.get("activation", "lncosh"),
              residual=model_kw.get("residual", False))
    return params, ws, x, kw


def compare_gcnn(name: str, ws, x, kw, tol: float, rows=None) -> float:
    """K2 against its plain version on the card; returns max abs error of
    S_g. Passes where |kernel - plain| <= tol + tol |plain|. With ``rows``
    the kernel runs on all of ``x`` (the launch shape under test) and its
    first ``rows`` rows are held against the plain version on them."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2

    got = k2.gcnn_group_sums(x, ws, **kw)
    n = x.shape[0] if rows is None else rows
    want = k2.gcnn_group_sums_reference(x[:n], ws, **kw)
    torch.cuda.synchronize()
    worst, max_abs = 0.0, 0.0
    for a, b in ((got.re[:n], want.re), (got.im[:n], want.im)):
        diff = (a - b).abs()
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, float((diff - tol * b.abs()).max()))
    print(f"  {name}: B={x.shape[0]}"
          + (f" (first {n} rows held)" if rows is not None else "")
          + f", S_g max abs err {max_abs:.3e} "
          f"(|S_g| ~ {float(want.re.abs().mean()):.3f}; tol {tol:g})")
    check(worst <= tol, f"{name}: S_g outside rtol/atol {tol}")
    return max_abs


def lncosh_at_scale(scale: float, batch: int, seed: int, dev) -> None:
    """Complex lncosh at large weights. log cosh z is taken on
    t = z sign(Re z), so its Im jumps by 2 pi k where Re z crosses 0 at
    |Im z| > pi/2, and a pre-activation within rounding of such a cut may
    land on either side in any two f32 summation orders. Counts the
    configurations whose S_g leaves 1e-4 of (1 + their largest |S_g|):
    K2 against the plain
    version (direct 4-product form), and, as the witness, the plain model
    (Karatsuba, ``LogPsiGCNN.group_sums``) against the same plain version.
    K2 may leave it on at most twice the witness's count plus 0.5% of the
    batch."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.models.cnn import module_names
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN

    model_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                    complex_params=True, param_scale=scale)
    model = LogPsiGCNN(**model_kw)
    params, ws, x, kw = gcnn_case(model_kw, batch, seed, dev, model=model)
    model.load_state_dict(module_names(params))
    model.to(dev)
    with torch.no_grad():
        got = k2.gcnn_group_sums(x, ws, **kw)
        want = k2.gcnn_group_sums_reference(x, ws, **kw)
        witness = model.group_sums(x)
    torch.cuda.synchronize()

    # rtol 1e-4 of each configuration's largest |S_g| (an Im part near 0
    # carries the rounding of sums as large as the Re parts)
    size = 1.0 + torch.maximum(want.re.abs(), want.im.abs()).amax(dim=1)

    def outside(a):  # configurations outside tolerance, max abs error
        diff = torch.maximum((a.re - want.re).abs(), (a.im - want.im).abs())
        bad = (diff > 1e-4 * size[:, None]).any(dim=1)
        return int(bad.sum()), float(diff.max())

    n_k2, err_k2 = outside(got)
    n_wit, err_wit = outside(witness)
    limit = 2 * n_wit + -(-5 * batch // 1000)
    print(f"  lncosh at weight scale {scale}, B={batch} (|S_g| ~ "
          f"{float(want.re.abs().mean()):.1f}): outside 1e-4, K2 vs plain "
          f"{n_k2} ({100 * n_k2 / batch:.2f}%, max abs err {err_k2:.3e}); "
          f"witness, Karatsuba model vs plain {n_wit} "
          f"({100 * n_wit / batch:.2f}%, max abs err {err_wit:.3e}); "
          f"limit {limit}")
    check(n_k2 <= limit, f"lncosh at scale {scale}: K2 leaves tolerance on "
          f"{n_k2} configurations, limit {limit}")


def check_log_psi(name: str, got, want, amplitudes: bool, tol: float,
                  phase_tol: float) -> None:
    """log psi ``got`` against ``want`` (C pairs): Re within tol (1 + |Re|)
    and phases within phase_tol mod 2 pi, or normalized amplitudes within
    phase_tol for a sign-changing character (exact nodes)."""
    import numpy as np
    import torch

    got, want = ([t.double().cpu() for t in lp] for lp in (got, want))
    if amplitudes:
        scale = float(want[0].max())

        def amp(lp):
            return (torch.exp(lp[0] - scale) * torch.exp(1j * lp[1])).numpy()

        err = float(np.abs(amp(got) - amp(want)).max())
        print(f"  {name}: normalized amplitude max err {err:.3e}")
        check(err <= phase_tol, f"{name}: amplitudes differ by {err}")
        return
    diff = (got[0] - want[0]).abs()
    d_re = float((diff / (1.0 + want[0].abs())).max())
    dphi = float((torch.remainder(got[1] - want[1] + np.pi, 2 * np.pi)
                  - np.pi).abs().max())
    print(f"  {name}: log psi re max err {float(diff.max()):.3e} (relative "
          f"to 1 + |Re| {d_re:.3e}), phase max err {dphi:.3e} (mod 2 pi)")
    check(d_re <= tol, f"{name}: Re log psi outside {tol}")
    check(dphi <= phase_tol, f"{name}: phases differ")


def compare_gcnn_log_psi(name: str, model, params, x, fused_kw: dict,
                         amplitudes: bool) -> None:
    """FusedLogPsi (K2) against the plain model's log psi: Re within
    1e-4 and phases mod 2 pi within 1e-3, or normalized amplitudes within
    1e-3 for a sign-changing character."""
    import torch
    from qmcnn_tpu_torch.kernels.gcnn_forward import FusedLogPsi
    from qmcnn_tpu_torch.models.cnn import log_psi_apply

    got = FusedLogPsi(**fused_kw)(params, x)
    want = log_psi_apply(model, params, x)
    torch.cuda.synchronize()
    check_log_psi(name, got, want, amplitudes, 1e-4, 1e-3)


def expected_launches(cfg, vmc, m=None) -> dict:
    """Launches of the kernel behind ``vmc``'s evaluation forward in one
    training step (the refresh; the sweeps: one launch of the fused sweep,
    or one per proposal of the torch loop, over every tempering replica;
    one per E_loc chunk; with ``optimizer.orthogonalize_to`` per frozen
    state the deflation's two forwards, psi_k on the live walkers and the
    live params on the frozen batch, in E_loc chunks where the chunk
    divides the batch, or the penalty's one psi_k forward), in the frozen
    batches' draw (``draw``: per state the refresh, the sweeps of
    max(n_therm_sweeps, 20) and the cached log psi_k), and in the whole
    train() run (the draw, the initial refresh, then a refresh and the
    sweeps per thermalization chunk), for ``m`` physical walkers (None: all
    of the config's; a rank's share under walker sharding)."""
    import numpy as np
    from qmcnn_tpu_torch.train import therm_chunks

    m = cfg.sampler.n_walkers if m is None else m
    sweep = cfg.sampler.sweep_size or int(np.prod(cfg.lattice.shape))

    def sweeps(n):
        return 1 if vmc.sampler.backend == "cuda" else n * sweep

    chunks = -(-m // (vmc.chunk_size or m))
    per_step = 1 + sweeps(cfg.sampler.n_sweeps_per_step) + chunks
    frozen = len(cfg.optimizer.orthogonalize_to or ())
    draw = 0
    if frozen:
        def fwd(n):  # ops/penalty.deflation_e_loc's chunks
            c = vmc.chunk_size
            return n // c if c and c < n and n % c == 0 else 1

        m0 = cfg.sampler.n_walkers
        per_step += frozen * (fwd(m) + fwd(m0)
                              if cfg.optimizer.deflate_c > 0 else 1)
        draw = frozen * (2 + sweeps(max(cfg.sampler.n_therm_sweeps, 20)))
    therm = sum(1 + sweeps(n) for _, n in
                therm_chunks(cfg.sampler.n_therm_sweeps,
                             cfg.run.therm_sweeps_per_dispatch))
    return {"per_step": per_step, "draw": draw,
            "run": draw + 1 + therm + cfg.run.n_steps * per_step}


def time_gcnn(ws, x, kw, card: str, label: str) -> dict:
    """K2 and its plain version (cuDNN, TF32 off) ms per call, and the
    bounds, at one shape."""
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.utils.mfu import TF32_PASSES

    batch = x.shape[0]
    reps = 3 if batch > 16384 else 10
    ms = cuda_ms(lambda: k2.gcnn_group_sums(x, ws, **kw), reps=reps)
    plain_ms = cuda_ms(lambda: k2.gcnn_group_sums_reference(x, ws, **kw),
                       reps=reps)
    hw = x.shape[1]
    width, n_layers = 8 * kw["channels"][0], len(kw["channels"])
    bound_ms, bound_by, fp32_ms, flop = gcnn_bound(ws, hw, width, n_layers,
                                                   batch)
    cplx = ws.lift_im is not None
    n_cfg = k2.configs_per_block(hw, width, 9, cplx)
    print(f"  {label} B={batch} ({card}): kernel {ms:.4f} ms, plain (cuDNN, "
          f"TF32 off) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({flop:.3e} FLOP, Karatsuba count, x {TF32_PASSES} TF32 passes, "
          f"{bound_by}) = {100 * bound_ms / ms:.1f}% of it; FP32-core bound "
          f"{fp32_ms:.4f} ms = {100 * fp32_ms / ms:.1f}%; kernel at "
          f"{flop / ms / 1e9:.2f} TFLOP/s of that work; {n_cfg} "
          f"configurations x {hw} sites per block, "
          f"{k2.launch_threads(hw, width, n_cfg)} threads, "
          f"{k2.smem_bytes(hw, width, 9, cplx, n_cfg)} bytes of shared "
          f"memory")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "fp32_bound_ms": fp32_ms}


def gcnn_main_path(card: str, out_dir: Path) -> dict:
    """configs/j1j2_8x8_gcnn.yaml at full width through train(), the K2
    counter zeroed just before and read just after; then one more step by
    hand for the launches per step, the minSR residual and E_im."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.train import train

    csv = out_dir / "j1j2_8x8_gcnn.csv"
    cfg = configs.load(str(GCNN_CONFIG), (
        "sampler.n_therm_sweeps=20", "run.n_steps=3", "run.log_every=1",
        f"run.csv_path={csv}"))
    vmc, _, _ = build(cfg, device="cuda")
    want = expected_launches(cfg, vmc)
    reset_counts()
    t0 = time.perf_counter()
    state, logger = train(cfg, device="cuda")
    torch.cuda.synchronize()
    launches, k1_launches = (k2.gcnn_group_sums.launches,
                             k1.metropolis_sweep.launches)
    check(k2.gcnn_group_sums.launches_bf16 == 0,
          "gcnn: the f32 path launched K2's bf16 route")
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    print(f"    j1j2_8x8_gcnn: {time.perf_counter() - t0:.1f} s, K2 launches "
          f"{launches} (expected {want['run']}; sweep kernel {k1_launches}), "
          f"E/site {[round(float(v) / 64, 5) for v in e]}, E_im "
          f"{[round(v, 5) for v in hist['energy_im']]}, accept "
          f"{acc.tolist()}, sr_iters {hist['sr_iters']}")
    check(np.isfinite(e).all(), "gcnn: non-finite energies")
    check(((acc > 0) & (acc < 1)).all(), "gcnn: accept rate outside (0, 1)")
    check(launches > 0, "gcnn: the training path never launched K2")
    check(launches == want["run"], f"gcnn: {launches} K2 launches, "
          f"expected {want['run']}")
    check(k1_launches == 0, "gcnn: the GCNN path launched the sweep kernel")

    new, per_step = one_more_step("gcnn", vmc, state, "k2_f32",
                                  want["per_step"])
    w = new.walkers
    # K2 on the trained lncosh params and the walkers' own (spin-flip
    # doubled) configurations; the count check ran before it
    ws = k2.expand_gcnn_params(new.params, 3, True, "params/inner/")
    compare_gcnn("after training, the walkers' configurations", ws,
                 torch.cat([w.s, -w.s]),
                 dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                      kernel_size=3), 1e-4)
    return {"launches": launches, "per_step": per_step, "cfg": cfg,
            "state": new}


def one_more_step(label: str, vmc, state, route: str, want_per_step: int):
    """One GCNN training step by hand, the counters zeroed just before: the
    K2 launches on ``route`` in it, E_im against 3 binned stderr of the
    walkers' E_loc, and a finite minSR residual. Returns (state, launches)."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.sampler.metropolis import prng_key
    from qmcnn_tpu_torch.utils.metrics import binned_stderr

    ids = torch.arange(state.walkers.s.shape[0], device="cuda")
    reset_counts()
    new, mt = vmc.step(state, prng_key(17), ids)
    torch.cuda.synchronize()
    n = counts()
    w = new.walkers
    e_loc = local_energy(vmc.eval_log_psi_fn, state.params, vmc.ham, w.s,
                         w.log_psi, chunk_size=vmc.chunk_size)
    err_im = binned_stderr(e_loc.im.double().cpu().numpy())
    e_im, resid = float(mt.energy_im), float(mt.sr_residual)
    print(f"    one more step: K2 launches {n} (expected {want_per_step} on "
          f"{route}), E_im {e_im:.5f} vs 3 x binned stderr "
          f"{3 * err_im:.5f}, minSR residual {resid:.3e}, sr_iters "
          f"{mt.sr_iters}, accept {float(mt.accept_rate):.4f}")
    check(n[route] == want_per_step and sum(n.values()) == n[route],
          f"{label}: launches {n} in a step, expected {want_per_step} on "
          f"{route}")
    check(abs(e_im) < 3 * err_im, f"{label}: |E_im| {e_im} >= 3 stderr")
    check(np.isfinite(resid) and mt.sr_iters == 0,
          f"{label}: minSR residual")
    return new, n[route]


def d12_fixture_energy(out_dir: Path, n_therm: int,
                       dtype: str = "float32"):
    """The depth-12 snapshot in its own architecture, in ``dtype`` (float32,
    or bfloat16 as its JAX run trained it: K2's bf16 route),
    warm-started from the npz, M=512, exchange_anti, a few minSR steps at
    the learning rate its JAX run ended at; the tail E/site must sit within
    0.01 of the JAX run's. Returns (config, final state)."""
    import numpy as np
    from qmcnn_tpu_torch import configs

    csv = out_dir / f"j1j2_8x8_d12_{dtype}.csv"
    cfg = configs.load(str(GCNN_CONFIG), D12_MODEL + (
        f"model.compute_dtype={dtype}",
        "sampler.n_walkers=512", f"sampler.n_therm_sweeps={n_therm}",
        f"run.init_from={D12_FIXTURE}", "run.n_steps=8", "run.log_every=1",
        "optimizer.lr=0.001", "optimizer.schedule=constant",
        "sr.diag_shift0=0.001", "sr.diag_shift_decay=1.0",
        "sr.diag_shift_min=0.001", "sr.proportional_shift=true",
        f"run.csv_path={csv}"))
    route = "k2_bf16" if dtype == "bfloat16" else "k2_f32"
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    tail, err = logger.tail_energy()
    e_site = tail / 64
    print(f"    d12 fixture ({dtype}): {time.perf_counter() - t0:.1f} s, "
          f"launches {n}, E/site {[round(float(v) / 64, 5) for v in e]}, "
          f"tail {e_site:.6f} +- {err / 64:.6f} (JAX run {E_SITE_D12}), "
          f"accept {hist['accept']}")
    check(np.isfinite(e).all(), "d12: non-finite energies")
    check(n[route] > 0 and sum(n.values()) == n[route],
          f"d12 ({dtype}): launches {n} are not all on the {dtype} route")
    check(abs(e_site - E_SITE_D12) <= 0.01,
          f"d12: E/site {e_site} not within 0.01 of {E_SITE_D12}")
    return cfg, state


# ---------------------------------------------------------------------------
# K2's bf16 route and the bf16 / complex paths
# ---------------------------------------------------------------------------

def print_ptxas(log: str) -> dict:
    """Print the registers and spills of every kernel in a build log, by
    kernel; returns {kernel<template args>: {"registers": n,
    "spill_store_bytes": n}}."""
    import re

    name, found = None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # e.g. ..._cu_ec29e88a24gcnn_forward_bf16_kernelILb1ELi1ELi20EE...
            m = re.search(r"(gcnn_forward_bf16_kernel|gcnn_forward_kernel"
                          r"|sweep_kernel)(?:I((?:L[a-z]\d+E)+)E)?", line)
            name = (m.group(1) + "<" + ",".join(re.findall(
                r"\d+", m.group(2) or "")) + ">") if m else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"    ptxas {name}: {line.split(':', 1)[-1].strip()}")
            rec = found.setdefault(name, {})
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rec["spill_store_bytes"] = int(m.group(1))
    return found


def sg_rel_err(got, want) -> tuple:
    """(max abs, max relative, mean signed relative) S_g error, relative to
    (1 + each configuration's largest |S_g|); the mean runs over the re and
    im parts of every S_g."""
    import torch

    size = 1.0 + torch.maximum(want.re.abs(), want.im.abs()).amax(dim=1)
    max_abs, max_rel, signed = 0.0, 0.0, 0.0
    for a, b in ((got.re, want.re), (got.im, want.im)):
        diff = a.to(b.device) - b
        max_abs = max(max_abs, float(diff.abs().max()))
        max_rel = max(max_rel, float((diff.abs() / size[:, None]).max()))
        signed += float((diff / size[:, None]).mean()) / 2
    return max_abs, max_rel, signed


def compare_gcnn_bf16(name: str, ws, x, kw, witness: bool = False) -> dict:
    """K2's bf16 route against its plain bf16 version on the card (cuDNN,
    TF32 off, on bf16 values); with ``witness``, also the plain version on
    the CPU (oneDNN's summation order) against the one on the card."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2

    got = k2.gcnn_group_sums(x, ws, compute_dtype="bfloat16", **kw)
    want = k2.gcnn_group_sums_reference(x, ws, compute_dtype="bfloat16",
                                        **kw)
    f32 = k2.gcnn_group_sums_reference(x, ws, **kw)
    torch.cuda.synchronize()
    max_abs, max_rel, signed = sg_rel_err(got, want)
    gap = sg_rel_err(f32, want)[1]
    text = ""
    if witness:
        cpu_ws = k2.GCNNWeights(*(None if w is None else w.cpu() for w in ws))
        other = k2.gcnn_group_sums_reference(x.cpu(), cpu_ws,
                                             compute_dtype="bfloat16", **kw)
        text = (f"; witness, plain on the CPU vs plain on the card: max rel "
                f"{sg_rel_err(other, want)[1]:.3e}")
    print(f"  {name}: B={x.shape[0]}, S_g max abs err {max_abs:.3e}, max "
          f"rel err {max_rel:.3e} (tol {BF16_TOL:g}), mean signed rel err "
          f"{signed:.3e} (|S_g| ~ "
          f"{float(want.re.abs().mean()):.3f}; bf16 vs f32 plain {gap:.3e})"
          f"{text}")
    check(max_rel <= BF16_TOL, f"{name}: bf16 S_g rel err {max_rel} > "
          f"{BF16_TOL}")
    check(gap > 0, f"{name}: the bf16 route does not round")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "mean_signed_rel_err": signed}


def compare_gcnn_log_psi_bf16(name: str, params, x, fused_kw: dict,
                              amplitudes: bool) -> None:
    """FusedLogPsi on the bf16 route against the same forward on the CPU
    (its plain bf16 version), within BF16_TOL (:func:`check_log_psi`)."""
    import torch
    from qmcnn_tpu_torch.kernels.gcnn_forward import FusedLogPsi

    fused = FusedLogPsi(compute_dtype="bfloat16", **fused_kw)
    got = fused(params, x)
    want = fused({k: v.cpu() for k, v in params.items()}, x.cpu())
    torch.cuda.synchronize()
    check_log_psi(name, got, want, amplitudes, BF16_TOL, BF16_TOL)


def reset_counts() -> None:
    """Every kernel launch counter to 0."""
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    k1.metropolis_sweep.launches = 0
    k2.gcnn_group_sums.launches = 0
    k2.gcnn_group_sums.launches_bf16 = 0


def counts() -> dict:
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    return {"k1": k1.metropolis_sweep.launches,
            "k2_f32": k2.gcnn_group_sums.launches,
            "k2_bf16": k2.gcnn_group_sums.launches_bf16}


def train_quiet(cfg, **kw):
    """train() with its stdout captured and echoed: (state, logger, text)."""
    from qmcnn_tpu_torch.train import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, logger = train(cfg, device="cuda", **kw)
    sys.stdout.write(buf.getvalue())
    return state, logger, buf.getvalue()


def states_equal(a, b) -> bool:
    """Params, optimizer state, SPRING's carry, the EMA and walkers bitwise
    equal."""
    import torch

    def eq(x, y):
        if isinstance(x, dict):
            return sorted(x) == sorted(y) and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y.to(x.device))
        return x == y

    wa, wb = a.walkers, b.walkers
    def same(x, y):
        return (x is None and y is None) or (
            x is not None and y is not None and eq(x, y))

    return (a.step == b.step and eq(a.params, b.params)
            and eq(a.opt_state, b.opt_state) and same(a.sr_aux, b.sr_aux)
            and same(a.ema, b.ema)
            and all(torch.equal(x, y) for x, y in (
                (wa.s, wb.s), (wa.log_psi.re, wb.log_psi.re),
                (wa.log_psi.im, wb.log_psi.im), (wa.n_accept, wb.n_accept),
                (wa.n_prop, wb.n_prop))))


def gcnn_r2_main_path(out_dir: Path, label: str = "gcnn_r2",
                      extra: tuple = ()) -> dict:
    """configs/j1j2_8x8_gcnn_r2.yaml at full width (M=1024, W=80, L=8, bf16,
    minSR, exchange_anti), with the overrides ``extra``, through train(): 3
    steps after 20 thermalization sweeps, checkpointed every step, the
    counters zeroed just before and read just after; then train() again to
    step 4, which must resume at step 3 from a checkpoint equal to the first
    run's state (SPRING's carried delta included, finite and non-zero where
    the run has one); then one more step by hand for the launches per step,
    E_im and the minSR (or SPRING) residual."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt_dir = out_dir / f"j1j2_8x8_{label}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    csv = out_dir / f"j1j2_8x8_{label}.csv"
    over = ("sampler.n_therm_sweeps=20", "run.log_every=1",
            f"run.ckpt_dir={ckpt_dir}", "run.ckpt_every=1",
            f"run.csv_path={csv}") + tuple(extra)
    cfg = configs.load(str(GCNN_R2_CONFIG), over + ("run.n_steps=3",))
    vmc, _, _ = build(cfg, device="cuda")
    check(isinstance(vmc.eval_log_psi_fn, k2.FusedLogPsi)
          and vmc.eval_log_psi_fn.compute_dtype == "bfloat16",
          f"{label}: K2's bf16 route does not serve the evaluation forward")
    want = expected_launches(cfg, vmc)
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg, ckpt_manager=CheckpointManager(
        str(ckpt_dir), keep=cfg.run.ckpt_keep))
    torch.cuda.synchronize()
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    print(f"    j1j2_8x8_{label}: {time.perf_counter() - t0:.1f} s, K2 bf16 "
          f"launches {n['k2_bf16']} (expected {want['run']}; K2 f32 "
          f"{n['k2_f32']}, sweep kernel {n['k1']}), E/site "
          f"{[round(float(v) / 64, 5) for v in e]}, E_im "
          f"{[round(v, 5) for v in hist['energy_im']]}, accept "
          f"{acc.tolist()}")
    check(np.isfinite(e).all(), f"{label}: non-finite energies")
    check(((acc > 0) & (acc < 1)).all(), f"{label}: accept outside (0, 1)")
    check(n["k2_bf16"] == want["run"], f"{label}: {n['k2_bf16']} K2 bf16 "
          f"launches, expected {want['run']}")
    check(n["k2_f32"] == 0 and n["k1"] == 0,
          f"{label}: launched K2 f32 {n['k2_f32']} / K1 {n['k1']} times")
    launches = n["k2_bf16"]

    # resume: the checkpoint of step 3 holds the first run's state bitwise
    mgr = CheckpointManager(str(ckpt_dir), keep=cfg.run.ckpt_keep)
    check(mgr.latest_step() == 3, f"{label}: latest checkpoint "
          f"{mgr.latest_step()}, expected 3")
    same = states_equal(mgr.restore(state), state)
    print(f"    checkpoint of step 3 restored: params, optimizer state and "
          f"walkers bitwise equal to the first run's final state: {same}")
    check(same, f"{label}: the restored state differs from the saved one")
    spring = state.sr_aux is not None
    if spring:
        aux = state.sr_aux
        print(f"    SPRING carry after step 3: |delta| "
              f"{float(torch.linalg.norm(aux)):.4e} over {aux.numel()} "
              f"params, saved and restored bitwise: {same}")
        check(bool(torch.isfinite(aux).all()) and bool((aux != 0).any()),
              f"{label}: SPRING's delta is not finite and non-zero")
    cfg4 = configs.load(str(GCNN_R2_CONFIG), over + ("run.n_steps=4",))
    reset_counts()
    state4, logger4, text = train_quiet(cfg4, ckpt_manager=mgr)
    torch.cuda.synchronize()
    n4 = counts()
    e4 = logger4.history["energy_re"]
    print(f"    resumed run: K2 bf16 launches {n4['k2_bf16']} (expected "
          f"{1 + want['per_step']}: the initial refresh and step 4), E/site "
          f"{[round(float(v) / 64, 5) for v in e4]}")
    check("resumed from checkpoint at step 3" in text,
          f"{label}: the second run did not resume at step 3")
    check(state4.step == 4 and len(e4) == 1 and np.isfinite(e4).all(),
          f"{label}: the resumed run did not take step 4 with a finite "
          "energy")
    check(n4["k2_bf16"] == 1 + want["per_step"],
          f"{label}: resumed run launched K2 bf16 {n4['k2_bf16']} times")

    if spring:
        aux4 = state4.sr_aux
        check(bool(torch.isfinite(aux4).all()) and bool((aux4 != 0).any())
              and not torch.equal(aux4, state.sr_aux),
              f"{label}: the resumed step did not update SPRING's delta")
    new, per_step = one_more_step(label, vmc, state4, "k2_bf16",
                                  want["per_step"])
    return {"launches": launches, "per_step": per_step, "cfg": cfg,
            "state": new}


def d12_energy_bias(cfg, walkers) -> None:
    """The depth-12 snapshot's E_loc on one set of walkers through K2's f32
    and bf16 routes: the mean difference must stay under 3 binned stderr of
    the f32 E_loc mean (bf16 brings no energy bias the sampling noise would
    show)."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build, fused_gcnn_log_psi
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.utils.metrics import binned_stderr
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    params = params_from_jax(load_checkpoint_params(str(D12_FIXTURE)),
                             "cuda")
    vmc, _, lattice = build(cfg, device="cuda")
    e = {}
    for dtype in ("float32", "bfloat16"):
        c = configs.apply_overrides(cfg, (f"model.compute_dtype={dtype}",))
        fused = fused_gcnn_log_psi(c, lattice)
        with torch.no_grad():
            lp = fused(params, walkers.s)
            e[dtype] = local_energy(fused, params, vmc.ham, walkers.s, lp,
                                    chunk_size=vmc.chunk_size).re.double()
    torch.cuda.synchronize()
    diff = float((e["bfloat16"] - e["float32"]).mean())
    err = binned_stderr(e["float32"].cpu().numpy())
    print(f"    d12 energy bias on {walkers.s.shape[0]} walkers: E_loc mean "
          f"f32 {float(e['float32'].mean()) / 64:.6f}/site, bf16 "
          f"{float(e['bfloat16'].mean()) / 64:.6f}/site; mean difference "
          f"{diff:.5f} vs binned stderr of the f32 mean {err:.5f} "
          f"({abs(diff) / err:.2f} stderr); per-walker |diff| max "
          f"{float((e['bfloat16'] - e['float32']).abs().max()):.4f}")
    check(np.isfinite(diff) and abs(diff) < 3 * err,
          f"d12: bf16 E_loc mean differs by {diff}, >= 3 x {err}")


def cnn_bf16_leg(out_dir: Path) -> None:
    """heis10x10_sr in bf16 warm-started from the bf16 JAX snapshot: the
    torch sweep and the bf16 model (K1 is f32-only, as in JAX), 50
    thermalization sweeps (the config's 100, halved: the torch sweep is
    host-bound), 5 steps; tail E/site within 0.01 of the JAX run's."""
    import numpy as np
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    csv = out_dir / "heis10x10_sr_bf16.csv"
    cfg = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"), (
        "model.compute_dtype=bfloat16", f"run.init_from={CNN_BF16_FIXTURE}",
        "sampler.n_therm_sweeps=50", "run.n_steps=5", "run.log_every=1",
        f"run.csv_path={csv}"))
    vmc, _, _ = build(cfg, device="cuda")
    check(vmc.sampler.backend == "torch"
          and not isinstance(vmc.eval_log_psi_fn, k1.FusedCNNLogPsi),
          "bf16 CNN: K1 would serve a bf16 model")
    reset_counts()
    t0 = time.perf_counter()
    _, logger, _ = train_quiet(cfg)
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    tail, err = logger.tail_energy()
    print(f"    heis10x10_sr bf16: {time.perf_counter() - t0:.1f} s, E/site "
          f"{[round(float(v) / 100, 5) for v in e]}, tail {tail / 100:.6f} "
          f"+- {err / 100:.6f} (JAX run {E_SITE_CNN_BF16}), accept "
          f"{acc.tolist()}, sr_iters {hist['sr_iters']}, launches {n}")
    check(np.isfinite(e).all(), "bf16 CNN: non-finite energies")
    check(((acc > 0) & (acc < 1)).all(), "bf16 CNN: accept outside (0, 1)")
    check(n["k1"] == 0, f"bf16 CNN: {n['k1']} sweep-kernel launches")
    check(abs(tail / 100 - E_SITE_CNN_BF16) <= 0.01,
          f"bf16 CNN: E/site {tail / 100} not within 0.01 of "
          f"{E_SITE_CNN_BF16}")


def complex_cnn_legs(out_dir: Path) -> None:
    """The complex CNN: the tfim12_h2 snapshot (N=12 TFIM at h=2, C=(12,12),
    k=5, flip moves, 2 sweeps per step; its config rebuilt from the JAX
    run's meta.json) warm-started for 10 steps, its tail within 1e-3
    relative of ED; and configs/j1j2_8x8_complex.yaml at full width (3
    steps after 20 thermalization sweeps, from its near-uniform fixed init,
    where a step may accept every proposal). K1 serves neither."""
    import numpy as np
    from qmcnn_tpu_torch import configs

    meta = json.loads(TFIM12_META.read_text())
    cfg = configs.apply_overrides(configs.from_yaml(meta["config"]), (
        f"run.init_from={TFIM12_FIXTURE}", "run.ckpt_dir=null",
        "run.n_steps=10", "run.log_every=1",
        f"run.csv_path={out_dir / 'tfim12_h2.csv'}"))
    check(cfg.model.complex_params, "tfim12_h2 is not the complex CNN")
    reset_counts()
    t0 = time.perf_counter()
    _, logger, _ = train_quiet(cfg)
    n = counts()
    tail, err = logger.tail_energy()
    rel = abs(tail - E_TFIM12_ED) / abs(E_TFIM12_ED)
    e = np.asarray(logger.history["energy_re"])
    print(f"    tfim12_h2: {time.perf_counter() - t0:.1f} s, tail "
          f"{tail:.6f} +- {err:.6f} vs ED {E_TFIM12_ED} (relative "
          f"{rel:.3e}; the JAX run {meta['rel_err']:.3e}), E_im "
          f"{[round(v, 5) for v in logger.history['energy_im']][-3:]}, "
          f"launches {n}")
    check(np.isfinite(e).all(), "tfim12_h2: non-finite energies")
    check(rel <= 1e-3, f"tfim12_h2: tail {tail} not within 1e-3 of ED")
    check(n["k1"] == 0, "tfim12_h2: the complex CNN launched K1")

    cfg = configs.load(str(ROOT / "configs" / "j1j2_8x8_complex.yaml"), (
        "sampler.n_therm_sweeps=20", "run.n_steps=3", "run.log_every=1",
        f"run.csv_path={out_dir / 'j1j2_8x8_complex.csv'}"))
    reset_counts()
    t0 = time.perf_counter()
    _, logger, _ = train_quiet(cfg)
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    print(f"    j1j2_8x8_complex: {time.perf_counter() - t0:.1f} s, E/site "
          f"{[round(float(v) / 64, 5) for v in e]}, accept {acc.tolist()}, "
          f"sr_iters {hist['sr_iters']}, launches {n}")
    check(np.isfinite(e).all(), "j1j2_8x8_complex: non-finite energies")
    # the config's fixed init (scale 0.05) is near-uniform, and an exchange
    # of an aligned bond is the identity: a step may accept every proposal
    check(((acc > 0) & (acc <= 1)).all(),
          "j1j2_8x8_complex: accept outside (0, 1]")
    check(min(hist["sr_iters"]) > 0, "j1j2_8x8_complex: pcg ran no "
          "iterations")
    check(n["k1"] == 0, "j1j2_8x8_complex: the complex CNN launched K1")


def e_im_check(label: str, vmc, state) -> None:
    """E_loc on the final walkers at the final params (the evaluation
    forward): |mean E_im| must stay under 3 binned stderr."""
    import numpy as np
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.utils.metrics import binned_stderr

    w = state.walkers
    lp = vmc.eval_log_psi_fn(state.params, w.s)
    e_loc = local_energy(vmc.eval_log_psi_fn, state.params, vmc.ham, w.s,
                         lp, chunk_size=vmc.chunk_size)
    e_im = float(e_loc.im.double().mean())
    err = binned_stderr(e_loc.im.double().cpu().numpy())
    print(f"    {label}: E_im on the final walkers {e_im:.5f} vs 3 x binned "
          f"stderr {3 * err:.5f}")
    check(np.isfinite(e_im) and abs(e_im) < 3 * err,
          f"{label}: |E_im| {e_im} >= 3 stderr {err}")


def meta_config(meta: Path, extra: tuple = ()):
    """A JAX run's own config (its meta.json), with the run's supervisor
    and checkpoint settings off and ``extra`` applied."""
    from qmcnn_tpu_torch import configs

    return configs.apply_overrides(
        configs.from_yaml(json.loads(meta.read_text())["config"]), (
            "run.ckpt_dir=null", "run.heartbeat_path=null",
            "run.log_every=1") + tuple(extra))


def fixture_leg(label: str, meta: Path, fixture: Path, e_site_ref: float,
                out_dir: Path, extra: tuple = (), tol: Optional[float] = 0.01
                ) -> tuple:
    """A trained JAX snapshot warm-started in its run's own config (rebuilt
    from its meta.json) at full width, on the card, the counters zeroed
    just before and read just after: the tail E/site within ``tol`` of
    ``e_site_ref``, the JAX run's tail (``tol`` None: the caller holds the
    run by other means), K1 and K2 launched 0 times (priors, D6 GCNNs,
    complex weights and the (1 + alpha H) ansatz take the plain model),
    |E_im| under 3 binned stderr. Returns (config, state, tail energy)."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.builder import build

    cfg = meta_config(meta, (
        f"run.init_from={fixture}",
        f"run.csv_path={out_dir / (label + '.csv')}") + tuple(extra))
    vmc, _, lattice = build(cfg, device="cuda")
    n_sites = lattice.n_sites
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    tail, err = logger.tail_energy()
    print(f"    {label}: {time.perf_counter() - t0:.1f} s, M="
          f"{cfg.sampler.n_walkers}, SR momentum {cfg.sr.momentum}, chunk "
          f"{vmc.chunk_size}, E/site "
          f"{[round(float(v) / n_sites, 5) for v in e]}, tail "
          f"{tail / n_sites:.6f} +- {err / n_sites:.6f} (JAX run "
          f"{e_site_ref}), accept {hist['accept'][-1]:.4f}, launches {n}")
    check(np.isfinite(e).all(), f"{label}: non-finite energies")
    check(sum(n.values()) == 0, f"{label}: launched a kernel {n}")
    check(tol is None or abs(tail / n_sites - e_site_ref) <= tol,
          f"{label}: E/site {tail / n_sites} not within {tol} of "
          f"{e_site_ref}")
    if cfg.sr.momentum:
        check(state.sr_aux is not None
              and bool(torch.isfinite(state.sr_aux).all()),
              f"{label}: SPRING's delta is missing or not finite")
    e_im_check(label, vmc, state)
    return cfg, state, tail


def frustrated_phase(out_dir: Path) -> dict:
    """Frustrated lattices and SPRING: the SPRING run's config (gcnn_r2 with
    sr.momentum 0.9) on K2's bf16 route with checkpoint and resume; the
    tri6x3_j1j2 snapshot (phase prior and Jastrow factors) against the
    port's ED; the kagome GCNN and PhaseNet snapshots with SPRING; and
    tri6x6_tgcnn at full width from a fresh init. Returns the SPRING leg's
    record and the D6 legs' configs and states for the step splits."""
    import numpy as np
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.train import exact_reference_energy

    t0 = time.perf_counter()
    spring = gcnn_r2_main_path(out_dir, "gcnn_r2_spring", SPRING_OVERRIDES)
    print(f"    SPRING leg {time.perf_counter() - t0:.1f} s")

    tri_cfg, _, tail = fixture_leg(
        "tri6x3_j1j2", TRI_META, TRI_FIXTURE, E_SITE_TRI, out_dir,
        ("sampler.n_therm_sweeps=100", "run.n_steps=10"))
    e_exact = exact_reference_energy(tri_cfg)
    rel = abs(tail - e_exact) / abs(e_exact)
    print(f"    tri6x3_j1j2 vs the port's ED {e_exact:.6f}: relative error "
          f"{rel:.3e}")
    check(tri_cfg.model.jastrow and tri_cfg.model.jastrow_phase,
          "tri6x3_j1j2: the snapshot's config lost its Jastrow factors")
    check(rel < 0.02, f"tri6x3_j1j2: relative error {rel} vs ED >= 0.02")

    kg = fixture_leg("kagome3x3_kgcnn", KGCNN_META, KGCNN_FIXTURE,
                     E_SITE_KGCNN, out_dir,
                     ("sampler.n_therm_sweeps=100", "run.n_steps=4"))
    fixture_leg("kagome3x3_phasenet", PHASENET_META, PHASENET_FIXTURE,
                E_SITE_PHASENET, out_dir,
                ("sampler.n_therm_sweeps=100", "run.n_steps=4"))

    csv = out_dir / "tri6x6_tgcnn.csv"
    cfg = configs.load(str(ROOT / "configs" / "tri6x6_tgcnn.yaml"), (
        "sampler.n_therm_sweeps=10", "run.n_steps=2", "run.log_every=1",
        f"run.csv_path={csv}"))
    vmc, _, _ = build(cfg, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    print(f"    tri6x6_tgcnn (W=96, radius-2 star, fresh init): "
          f"{time.perf_counter() - t0:.1f} s, auto chunk_size "
          f"{vmc.chunk_size} (jacobian_chunk {vmc.sr.jacobian_chunk}), "
          f"E/site {[round(float(v) / 36, 5) for v in e]}, accept "
          f"{acc.tolist()}, launches {n}")
    check(np.isfinite(e).all(), "tri6x6_tgcnn: non-finite energies")
    check(((acc > 0) & (acc < 1)).all(),
          "tri6x6_tgcnn: accept outside (0, 1)")
    check(sum(n.values()) == 0, f"tri6x6_tgcnn: launched a kernel {n}")
    return {"spring": spring, "tgcnn": (cfg, state), "kgcnn": kg[:2]}


def all_configs(n: int, sz0: bool, device):
    """Every configuration of n spins [2^n, n] in {-1, +1} on ``device``,
    or only those with S^z = 0."""
    import torch

    idx = torch.arange(2 ** n, device=device)[:, None]
    bits = (idx >> torch.arange(n - 1, -1, -1, device=device)) & 1
    s = (2.0 * bits - 1.0).to(torch.float32)
    return s[s.sum(-1) == 0] if sz0 else s


def exact_sampling_leg(label: str, config: str, n_configs: int) -> None:
    """A fresh ARNN config on the card: Sum_s |psi(s)|^2 over every
    configuration (of its sector) equals 1 within 1e-4, and the sampled
    mean energy of one training step (vmc.step, the direct sampler's
    walkers) lies within 4 stderr of Sum_s |psi(s)|^2 E_loc(s); K1 and K2
    launched 0 times."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key

    cfg = configs.load(str(ROOT / "configs" / config))
    vmc, params, lattice = build(cfg, device="cuda")
    m = cfg.sampler.n_walkers
    reset_counts()
    t0 = time.perf_counter()
    s = all_configs(lattice.n_sites, vmc.sampler.sz_zero, "cuda")
    check(s.shape[0] == n_configs, f"{label}: {s.shape[0]} configurations")
    with torch.no_grad():
        lp = vmc.log_psi_fn(params, s)
        prob = torch.exp(2.0 * lp.re.double())
        norm = float(prob.sum())
        e_loc = local_energy(vmc.log_psi_fn, params, vmc.ham, s, lp)
        e_exact = float((prob * e_loc.re.double()).sum() / norm)
    key = prng_key(cfg.run.seed + 100)
    state = vmc.init_state(fold_in(key, 0), m, params, device="cuda")
    state, mt = vmc.step(state, fold_in(key, 2),
                         torch.arange(m, device="cuda"))
    n = counts()
    e_step = float(mt.energy_re)
    err = float(np.sqrt(float(mt.energy_var) / m))
    print(f"    {label} (fresh, {n_configs} configurations): "
          f"{time.perf_counter() - t0:.1f} s, Sum |psi|^2 = {norm:.7f}, "
          f"exact <E> {e_exact:.5f}, one step's sampled mean {e_step:.5f} "
          f"+- {err:.5f}, accept {float(mt.accept_rate)}, launches {n}")
    check(abs(norm - 1.0) < 1e-4, f"{label}: Sum |psi|^2 = {norm}")
    check(abs(e_step - e_exact) < 4 * err,
          f"{label}: sampled <E> {e_step} not within 4 stderr of {e_exact}")
    check(float(mt.accept_rate) == 1.0, f"{label}: acceptance != 1")
    check(sum(n.values()) == 0, f"{label}: launched a kernel {n}")


def small_leg(label: str, config: str, over: tuple, out_dir: Path):
    """A few steps of a config with overrides through train(): finite
    energies, K1 and K2 launched 0 times. Returns (config, state,
    logger)."""
    import numpy as np
    from qmcnn_tpu_torch import configs

    cfg = configs.load(str(ROOT / "configs" / config), over + (
        "run.log_every=1", f"run.csv_path={out_dir / (label + '.csv')}"))
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    e = np.asarray(logger.history["energy_re"])
    print(f"    {label}: {time.perf_counter() - t0:.1f} s, E/site "
          f"{[round(float(v) / state.walkers.s.shape[1], 5) for v in e]}, "
          f"accept {logger.history['accept']}, launches {n}")
    check(np.isfinite(e).all(), f"{label}: non-finite energies")
    check(sum(n.values()) == 0, f"{label}: launched a kernel {n}")
    return cfg, state, logger


def families_phase(out_dir: Path) -> dict:
    """The last ansatz families and the XYZ model: the ViT snapshots (4x4
    against the port's ED, 8x8), the kagome ARNN snapshot with the direct
    sampler, exact sampling checked by enumeration (tfim16_arnn, and
    j1j2_4x4_arnn in its S^z = 0 sector), heis40_arnn in its sector, both
    ViT configs from a fresh init, an RBM, a translation- and point-group-
    averaged CNN and an XYZ chain; K1 and K2 launched 0 times on every
    leg. Returns the configs and states for the step splits."""
    import torch
    from qmcnn_tpu_torch.builder import resolve_move
    from qmcnn_tpu_torch.train import exact_reference_energy

    vit4_cfg, _, tail = fixture_leg(
        "j1j2_4x4_vit_cap", VIT4_META, VIT4_FIXTURE, E_SITE_VIT4, out_dir,
        ("sampler.n_therm_sweeps=100", "run.n_steps=10"))
    e_exact = exact_reference_energy(vit4_cfg)
    rel = abs(tail - e_exact) / abs(e_exact)
    print(f"    j1j2_4x4_vit_cap vs the port's ED {e_exact:.6f}: relative "
          f"error {rel:.3e}")
    check(rel < 1e-2, f"j1j2_4x4_vit_cap: relative error {rel} vs ED")
    vit8 = fixture_leg("j1j2_8x8_vit_cap", VIT8_META, VIT8_FIXTURE,
                       E_SITE_VIT8, out_dir,
                       ("sampler.n_therm_sweeps=25", "run.n_steps=4"))
    karnn = fixture_leg("kagome3x3_r3_arnn", KARNN_META, KARNN_FIXTURE,
                        E_SITE_KARNN, out_dir, ("run.n_steps=4",))
    check(karnn[1].walkers.n_accept.sum() == karnn[1].walkers.n_prop.sum(),
          "kagome3x3_r3_arnn: acceptance != 1")

    exact_sampling_leg("tfim16_arnn", "tfim16_arnn.yaml", 2 ** 16)
    exact_sampling_leg("j1j2_4x4_arnn", "j1j2_4x4_arnn.yaml", 12870)

    heis = small_leg("heis40_arnn", "heis40_arnn.yaml", ("run.n_steps=5",),
                     out_dir)
    s = heis[1].walkers.s
    check(bool((s.sum(-1) == 0).all()) and set(s.unique().tolist())
          == {-1.0, 1.0}, "heis40_arnn: a sample left S^z = 0")
    check(heis[2].history["accept"] == [1.0] * 5,
          "heis40_arnn: acceptance != 1")

    for config in ("j1j2_4x4_vit", "j1j2_8x8_vit"):
        small_leg(config, f"{config}.yaml",
                  ("sampler.n_therm_sweeps=10", "run.n_steps=2"), out_dir)
    small = ("lattice.shape=[4,4]", "model.channels=[4,4]",
             "sampler.n_walkers=256", "sampler.n_therm_sweeps=5",
             "run.n_steps=3")
    small_leg("rbm_4x4", "heis10x10_sr.yaml", small + (
        "model.kind=rbm", "model.complex_params=true"), out_dir)
    small_leg("cnn_4x4_averaged", "heis10x10_sr.yaml", small + (
        "model.translation_average=true", "model.point_group_average=true"),
        out_dir)
    cfg, state, _ = small_leg("xyz16", "tfim16_sgd.yaml", (
        "hamiltonian.kind=xyz", "hamiltonian.jx=1.0", "hamiltonian.jy=0.5",
        "hamiltonian.jz=0.8", "hamiltonian.hx=0.3",
        "model.complex_params=true", "run.n_steps=5",
        "run.validate_against_ed=true"), out_dir)
    check(resolve_move(cfg) == "flip" and state.walkers.s.shape[1] == 16,
          "xyz16: not the flip-move chain")
    torch.cuda.synchronize()
    return {"vit8": vit8[:2], "karnn": karnn[:2], "heis40": heis[:2]}


def direct_split(cfg, state, card: str, label: str) -> None:
    """step_split of a direct-sampler run, with the sampler's ms per
    site."""
    totals = step_split(cfg, state, card, label)
    n = state.walkers.s.shape[1]
    print(f"  {label}: direct sampler {totals['sample'] / n:.3f} ms per "
          f"site ({n} sites, M={state.walkers.s.shape[0]}; {card})")


def time_gcnn_bf16(ws, x, kw, card: str, label: str) -> dict:
    """K2's bf16 route, its plain bf16 version and K2's f32 route at one
    shape: ms per call, and the bf16 bound (the least FLOP at the dense bf16
    tensor-core rate, or the bytes) beside the f32 route's 3xTF32 bound."""
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.utils.mfu import H100_BF16_FLOPS, gcnn_flop

    batch = x.shape[0]
    reps = 3 if batch > 16384 else 10
    ms = cuda_ms(lambda: k2.gcnn_group_sums(x, ws, compute_dtype="bfloat16",
                                            **kw), reps=reps)
    plain_ms = cuda_ms(lambda: k2.gcnn_group_sums_reference(
        x, ws, compute_dtype="bfloat16", **kw), reps=1 if batch > 16384
        else reps)
    f32_ms = cuda_ms(lambda: k2.gcnn_group_sums(x, ws, **kw), reps=reps)
    hw = x.shape[1]
    width, n_layers = 8 * kw["channels"][0], len(kw["channels"])
    cplx = ws.lift_im is not None
    flop = gcnn_flop(hw, width, n_layers, cplx, batch)
    # x read once (f32 spins), the weights once (bf16 group layers, f32
    # lift and biases), S_g written once
    n_bytes = (4 * batch * hw + 4 * batch * 16
               + 2 * sum(w.numel() for w in (ws.w_re, ws.w_im)
                         if w is not None)
               + 4 * sum(w.numel() for w in (ws.lift_re, ws.lift_im, ws.b_re,
                                             ws.b_im) if w is not None))
    tc_ms = flop / H100_BF16_FLOPS * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(tc_ms, bytes_ms)
    bound_by = "operations" if tc_ms >= bytes_ms else "bytes"
    f32_bound = gcnn_bound(ws, hw, width, n_layers, batch)[0]
    n_cfg = k2.configs_per_block(hw, width, 9, cplx, "bfloat16")
    plan = k2.bf16_plan(hw, width, 9, cplx, n_cfg // k2.bf16_group_configs(
        hw))
    print(f"  {label} B={batch} ({card}): bf16 route {ms:.4f} ms, plain "
          f"bf16 version (cuDNN, TF32 off) {plain_ms:.4f} ms, bf16 bound "
          f"{bound_ms:.4f} ms ({flop:.3e} FLOP at {H100_BF16_FLOPS:.3g} bf16 "
          f"FLOP/s, {bound_by}) = {100 * bound_ms / ms:.1f}% of it; the f32 "
          f"route {f32_ms:.4f} ms at the same shape (3xTF32 bound "
          f"{f32_bound:.4f} ms), ratio bf16/f32 {ms / f32_ms:.3f}; {n_cfg} "
          f"configurations x {hw} sites per block (f32: "
          f"{k2.configs_per_block(hw, width, 9, cplx)}) in {plan.n_wg} "
          f"consumer warpgroups, {plan.threads} threads, a ring of "
          f"{plan.stages} stages of {plan.stage_bytes} bytes, "
          f"{plan.smem_bytes} bytes of shared memory")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "f32_route_ms": f32_ms,
            "f32_route_bound_ms": f32_bound}


# ---------------------------------------------------------------------------
# walker sharding: ranks on the card against the 1-rank run
# ---------------------------------------------------------------------------

#: ranks of the sharded legs, spawned as processes on cuda:0 with a gloo
#: group (NCCL refuses two ranks on one card)
# ---------------------------------------------------------------------------
# excited states, EMA, sectors, the (1 + alpha H) ansatz and tempering
# ---------------------------------------------------------------------------

def defl8_config(out_dir: Path, n_steps: int):
    """The 8x8 E1 deflation run's config (its meta.json: the bf16 depth-12
    residual GCNN, M = 1024, SPRING-minSR, c = 2, EMA 0.998) warm-started
    from its snapshot against the d12 ground state, 100 thermalization
    sweeps, a checkpoint every step, at the learning rate the run ended at
    (its cosine over 1,800 steps ends at 0.1 x 0.01)."""
    ckpt = out_dir / "j1j2_8x8_excited_defl_ckpt"
    return meta_config(DEFL8_META, (
        f"run.init_from={DEFL8_FIXTURE}", "run.init_noise=0.0",
        f"optimizer.orthogonalize_to=[{DEFL8_FROZEN}]",
        "optimizer.schedule=constant", "optimizer.lr=0.001",
        "sampler.n_therm_sweeps=100", f"run.n_steps={n_steps}",
        f"run.ckpt_dir={ckpt}", "run.ckpt_every=1",
        f"run.csv_path={out_dir / 'j1j2_8x8_excited_defl.csv'}"))


def defl8_leg(out_dir: Path) -> dict:
    """The slice's main path: the 8x8 E1 deflation through train(), 4 steps
    checkpointed every step, then train() again to step 5, which must
    resume at step 4 from a checkpoint bitwise equal to the first run's
    state (the EMA and SPRING's delta included). Every evaluation forward,
    the frozen state's included, runs on K2's bf16 route at the expected
    count; K2 f32 and K1 launch 0 times. Returns the config, the built VMC
    (its frozen batch drawn once more, counted apart) and the final
    state."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = defl8_config(out_dir, 4)
    shutil.rmtree(cfg.run.ckpt_dir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    vmc, _, _ = build(cfg, device="cuda")
    n_draw = counts()
    (frozen,) = vmc.penalty_states
    want = expected_launches(cfg, vmc)
    print(f"    frozen batch of {DEFL8_FROZEN.name}: "
          f"{tuple(frozen.s_frozen.shape)} drawn in "
          f"{time.perf_counter() - t0:.1f} s, launches {n_draw} (expected "
          f"{want['draw']} on k2_bf16), chunk {vmc.chunk_size}")
    for fwd in (vmc.eval_log_psi_fn, frozen.log_psi_fn):
        check(isinstance(fwd, k2.FusedLogPsi)
              and fwd.compute_dtype == "bfloat16",
              "defl8: K2's bf16 route does not serve an evaluation forward")
    check(frozen.log_psi_fn is not vmc.eval_log_psi_fn,
          "defl8: the frozen state shares the live weight cache")
    check(n_draw == {"k1": 0, "k2_f32": 0, "k2_bf16": want["draw"]},
          f"defl8: the frozen draw launched {n_draw}")
    mgr = CheckpointManager(str(cfg.run.ckpt_dir), keep=cfg.run.ckpt_keep)
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg, ckpt_manager=mgr)
    torch.cuda.synchronize()
    n = counts()
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    ovl = np.asarray(hist["overlap"])
    tail, err = logger.tail_energy()
    print(f"    j1j2_8x8_excited_defl: {time.perf_counter() - t0:.1f} s, K2 "
          f"bf16 launches {n['k2_bf16']} (expected {want['run']} = draw "
          f"{want['draw']} + 1 + thermalization + 4 x {want['per_step']}; "
          f"K2 f32 {n['k2_f32']}, K1 {n['k1']}), E/site "
          f"{[round(float(v) / 64, 5) for v in e]}, tail {tail / 64:.6f} +- "
          f"{err / 64:.6f} (JAX run {E_SITE_DEFL8}), overlap "
          f"{[round(float(v), 4) for v in ovl]}, accept {hist['accept']}")
    check(np.isfinite(e).all(), "defl8: non-finite energies")
    check(n == {"k1": 0, "k2_f32": 0, "k2_bf16": want["run"]},
          f"defl8: launches {n}, expected {want['run']} on k2_bf16")
    check(abs(tail / 64 - E_SITE_DEFL8) <= 0.01,
          f"defl8: E/site {tail / 64} not within 0.01 of {E_SITE_DEFL8}")
    check(np.isfinite(ovl).all() and ((ovl > 0.02) & (ovl < 0.6)).all(),
          f"defl8: overlap {ovl.tolist()} outside (0.02, 0.6)")
    ema_path = Path(f"{cfg.run.csv_path}.ema.npz")
    check(ema_path.is_file(), f"defl8: {ema_path.name} was not written")
    with np.load(ema_path) as z:
        check(sorted(z.files) == sorted(state.ema) and all(
            np.array_equal(z[k], state.ema[k].cpu().numpy())
            for k in z.files), "defl8: .ema.npz is not the final EMA")
    check(mgr.latest_step() == 4, f"defl8: latest checkpoint "
          f"{mgr.latest_step()}, expected 4")
    same = states_equal(mgr.restore(state), state)
    print(f"    checkpoint of step 4 restored (params, optimizer state, "
          f"SPRING's delta, the EMA, walkers) bitwise: {same}; EMA - params "
          f"max |diff| {max(float((state.ema[k] - state.params[k]).abs().max()) for k in state.ema):.3e}")
    check(same, "defl8: the restored state differs from the saved one")
    cfg5 = defl8_config(out_dir, 5)
    reset_counts()
    state5, logger5, text = train_quiet(cfg5, ckpt_manager=mgr)
    torch.cuda.synchronize()
    n5 = counts()
    e5 = logger5.history["energy_re"]
    print(f"    resumed run: K2 bf16 launches {n5['k2_bf16']} (expected "
          f"{want['draw'] + 1 + want['per_step']}: the draw, the refresh and "
          f"step 5), E/site {[round(float(v) / 64, 5) for v in e5]}, "
          f"overlap {logger5.history['overlap']}")
    check("resumed from checkpoint at step 4" in text,
          "defl8: the second run did not resume at step 4")
    check(state5.step == 5 and len(e5) == 1 and np.isfinite(e5).all(),
          "defl8: the resumed run did not take step 5 with a finite energy")
    check(n5 == {"k1": 0, "k2_f32": 0,
                 "k2_bf16": want["draw"] + 1 + want["per_step"]},
          f"defl8: the resumed run launched {n5}")
    check(not states_equal(state5, state) and any(
        not torch.equal(state5.ema[k], state.ema[k]) for k in state.ema),
        "defl8: the resumed step did not move the EMA")
    return {"cfg": cfg5, "vmc": vmc, "state": state5, "launches": n["k2_bf16"],
            "per_step": want["per_step"], "draw": want["draw"]}


def defl4_config(out_dir: Path, n_steps: int, extra: tuple = ()):
    """The 4x4 E1 deflation run's config (complex CNN 16^3, M = 1024,
    SPRING-minSR, c = 2) from its snapshot against its ground state, at
    the learning rate the run ended at (0.1 x 0.02)."""
    return meta_config(DEFL4_META, (
        f"run.init_from={DEFL4_FIXTURE}", "run.init_noise=0.0",
        f"optimizer.orthogonalize_to=[{DEFL4_FROZEN}]",
        "optimizer.schedule=constant", "optimizer.lr=0.002",
        f"run.n_steps={n_steps}",
        f"run.csv_path={out_dir / 'j1j2_4x4_excited_defl.csv'}") + extra)


def defl4_leg(out_dir: Path) -> tuple:
    """The 4x4 E1 deflation, 20 steps: the tail within 0.01/site of the
    JAX run and 3% of the sector-ED E1, |overlap| under 0.05; no kernel
    (the complex CNN takes the plain model, as in JAX)."""
    import numpy as np
    from qmcnn_tpu_torch.builder import build

    cfg = defl4_config(out_dir, 20)
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    ovl = np.abs(np.asarray(logger.history["overlap"]))
    tail, err = logger.tail_energy()
    rel = abs(tail - E1_4X4_ED) / abs(E1_4X4_ED)
    print(f"    j1j2_4x4_excited_defl: {time.perf_counter() - t0:.1f} s, "
          f"tail {tail / 16:.6f} +- {err / 16:.6f} per site (JAX run "
          f"{E_SITE_DEFL4}), {tail:.5f} against the sector-ED E1 "
          f"{E1_4X4_ED}: {100 * rel:.2f}%, max |overlap| {ovl.max():.2e}, "
          f"launches {n}")
    check(np.isfinite(logger.history["energy_re"]).all(),
          "defl4: non-finite energies")
    check(sum(n.values()) == 0, f"defl4: launched a kernel {n}")
    check(abs(tail / 16 - E_SITE_DEFL4) <= 0.01,
          f"defl4: E/site {tail / 16} not within 0.01 of {E_SITE_DEFL4}")
    check(rel < 0.03, f"defl4: {rel} from the sector-ED E1")
    check(np.isfinite(ovl).all() and ovl.max() < 0.05,
          f"defl4: |overlap| {ovl.max()} >= 0.05")
    vmc, _, _ = build(cfg, device="cuda")
    return cfg, vmc, state


def swap_acceptance(sampler, walkers, key: int) -> list:
    """Each adjacent pair's acceptance in one replica-exchange pass over
    ``walkers``: the pass run pair by pair through the sampler's own
    ``_swap_step``, every other pair's uniform set to 1 (log 0 < nothing),
    counting the ladders whose pair swapped."""
    import torch
    from qmcnn_tpu_torch.sampler.metropolis import swap_noise

    r = sampler.n_replicas
    m = walkers.s.shape[0] // r
    log_u = swap_noise(key, torch.arange(m, device=walkers.s.device), 1,
                       r - 1)[0]
    out = []
    for j in range(r - 1):
        only = torch.full_like(log_u, float("inf"))
        only[j] = log_u[j]
        new = sampler._swap_step(walkers, only)
        moved = (new.s.reshape(m, r, -1)[:, j]
                 != walkers.s.reshape(m, r, -1)[:, j]).any(-1)
        out.append(float(moved.double().mean()))
        walkers = new
    return out


def tempering_config(out_dir: Path, n_steps: int = 3, n_therm: int = 20):
    """heis10x10_sr from the fixture with the ladder TEMPER_BETAS (M = 2048
    physical walkers, 6,144 rows)."""
    from qmcnn_tpu_torch import configs

    return configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"), (
        f"run.init_from={FIXTURE}",
        "sampler.tempering_betas=[" + ",".join(map(str, TEMPER_BETAS)) + "]",
        f"sampler.n_therm_sweeps={n_therm}", f"run.n_steps={n_steps}",
        "run.log_every=1", f"run.csv_path={out_dir / 'heis10x10_temper.csv'}"))


def tempering_leg(out_dir: Path) -> tuple:
    """Parallel tempering at full width: the b = 1 tail within 0.01/site of
    the fixture's JAX run, each pair's swap acceptance in (0, 1), K1's
    fused sweep unused (the torch loop) and its recompute forward at the
    expected count (one launch per proposal over all 6,144 rows)."""
    import numpy as np
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.sampler.metropolis import prng_key

    cfg = tempering_config(out_dir)
    vmc, _, _ = build(cfg, device="cuda")
    check(vmc.sampler.backend == "torch"
          and isinstance(vmc.eval_log_psi_fn, k1.FusedCNNLogPsi),
          "tempering: not the torch loop over K1's recompute forward")
    want = expected_launches(cfg, vmc)
    reset_counts()
    t0 = time.perf_counter()
    state, logger, _ = train_quiet(cfg)
    n = counts()
    tail, err = logger.tail_energy()
    acc = swap_acceptance(vmc.sampler, state.walkers, prng_key(23))
    print(f"    heis10x10_sr tempered {TEMPER_BETAS}: "
          f"{time.perf_counter() - t0:.1f} s, rows "
          f"{state.walkers.s.shape[0]}, K1 launches {n['k1']} (expected "
          f"{want['run']}, all recompute: {want['per_step']} per step), b = 1 "
          f"tail {tail / 100:.6f} +- {err / 100:.6f} per site (fixture "
          f"{E_SITE_FIXTURE}), swap acceptance per pair "
          f"{[round(a, 4) for a in acc]}, accept {logger.history['accept']}")
    check(np.isfinite(logger.history["energy_re"]).all(),
          "tempering: non-finite energies")
    check(n == {"k1": want["run"], "k2_f32": 0, "k2_bf16": 0},
          f"tempering: launches {n}, expected {want['run']} on k1")
    check(abs(tail / 100 - E_SITE_FIXTURE) <= 0.01,
          f"tempering: E/site {tail / 100} not within 0.01 of "
          f"{E_SITE_FIXTURE}")
    check(all(0.0 < a < 1.0 for a in acc),
          f"tempering: swap acceptance {acc} outside (0, 1)")
    return cfg, vmc, state


def excited_phase(out_dir: Path, card: str) -> dict:
    """Excited states, EMA, sectors, the (1 + alpha H) ansatz and
    tempering, each leg's counters zeroed just before it and read just
    after it, and each leg's step split beside the card."""
    import numpy as np
    from qmcnn_tpu_torch.utils.transfer import load_checkpoint_params

    legs = {}
    t0 = time.perf_counter()
    legs["defl8"] = defl8_leg(out_dir)
    print(f"    8x8 deflation leg {time.perf_counter() - t0:.1f} s")
    legs["defl4"] = defl4_leg(out_dir)

    alpha0 = load_checkpoint_params(str(LANCZOS_FIXTURE))["lanczos/alpha"]
    cfg, state, tail = fixture_leg(
        "kagome3x3_r5_lanczos_refine", LANCZOS_META, LANCZOS_FIXTURE,
        E_SITE_LANCZOS, out_dir, (
            "sampler.n_therm_sweeps=20", "run.n_steps=3",
            "optimizer.schedule=constant", "optimizer.lr=0.0003",
            "sr.diag_shift0=0.001"))
    alpha = state.params["lanczos/alpha"].cpu().numpy()
    rel = abs(tail / 27 - E_SITE_KAGOME_ED) / abs(E_SITE_KAGOME_ED)
    print(f"    (1 + alpha H) psi: alpha {alpha.tolist()} after 3 steps from "
          f"the snapshot's {alpha0.tolist()} (configured "
          f"{cfg.model.lanczos_alpha}); tail {tail / 27:.6f} per site, "
          f"{100 * rel:.2f}% from kagome-27 ED {E_SITE_KAGOME_ED}")
    check(np.abs(alpha - alpha0).max() < 0.005,
          "lanczos: alpha did not start from the snapshot's")
    check(rel < 0.02, f"lanczos: {rel} from ED")
    legs["lanczos"] = (cfg, None, state)

    # E_q is not held to the JAX run's tail: restarted from this snapshot,
    # the nearest-neighbour exchange sampler leaves walkers trapped beside
    # a J2-connected configuration e^6 to e^10 more probable, in both
    # packages, and the JAX package's own 3-step runs from it read -0.38
    # to +0.12 per site (PERF.md, PR 10). The step on the card is held to
    # the plain CPU step on the same walkers instead.
    cfg, state, tail = fixture_leg(
        "j1j2_8x8_sector_pipi", SECTOR_META, SECTOR_FIXTURE, E_SITE_SECTOR,
        out_dir, ("run.n_steps=3", "optimizer.schedule=constant",
                  "optimizer.lr=0.002"), tol=None)
    log = fixture_log(cfg)
    weight = np.asarray(log["sector_weight"])
    print(f"    sector (pi, pi): E_q per site per step "
          f"{[round(v, 4) for v in log['e_per_site']]}, var(e_eff) "
          f"{log['energy_var']}, tail {tail / 64:.6f} (JAX run "
          f"{E_SITE_SECTOR}, not held), sector weight {weight.tolist()} "
          f"(JAX run 0.015625)")
    check(np.isfinite(log["energy_re"]).all(), "sector: non-finite E_q")
    check(np.abs(weight - 1 / 64).max() < 1e-4,
          f"sector: weight {weight.tolist()} is not the JAX run's 1/64")
    gain = connected_gain(cfg, state)
    print(f"    sector walkers: the largest gain of Re log psi to an "
          f"H-connected configuration {gain.max():.3f}; walkers with a gain "
          f"above 3: {int((gain > 3).sum())} of {gain.size}, above 6: "
          f"{int((gain > 6).sum())}")
    sector_step_parity(cfg, state)
    legs["sector"] = (cfg, None, state)

    legs["tempering"] = tempering_leg(out_dir)

    splits = {}
    for name, label in (("defl8", "j1j2_8x8_excited_defl"),
                        ("defl4", "j1j2_4x4_excited_defl"),
                        ("lanczos", "kagome3x3_r5_lanczos_refine"),
                        ("sector", "j1j2_8x8_sector_pipi"),
                        ("tempering", "heis10x10_sr tempered")):
        leg = legs[name]
        cfg, vmc, state = ((leg["cfg"], leg["vmc"], leg["state"])
                           if isinstance(leg, dict) else leg)
        splits[name] = step_split(cfg, state, card, label, vmc=vmc)
    return {"defl8": legs["defl8"], "splits": splits}


def jax_report(path: Path) -> dict:
    """The JSON report in a JAX ``measure`` log (the lines from ``{`` to
    ``}``)."""
    text = path.read_text()
    start = text.index("{\n")
    return json.loads(text[start:text.index("\n}", start) + 2])


def measure_expected(cfg, vmc, lattice, n_samples: int, therm: int,
                     total_spin: bool = False, sector: bool = False,
                     lanczos: bool = False, regions: int = 0,
                     sma_disps: int = 0, fidelity: bool = False,
                     m: Optional[int] = None, sweeps_between: int = 2
                     ) -> int:
    """Launches of the kernel behind ``vmc``'s evaluation forward in one
    ``measure()`` run on ``m`` walkers (a rank's; default all): the initial
    refresh; a refresh and the sweeps (one launch of the fused sweep, or
    one per proposal) per thermalization chunk of ``therm`` sweeps; per
    sample a refresh and ``sweeps_between`` sweeps, one per E_loc chunk, one per NN S.S
    chunk (site grids), K + 2 per Lanczos chunk (the connected states,
    their E_loc in K inner chunks, the walkers' E_loc), two per sector
    chunk (the projected log psi of the connected and of the walkers'
    configurations), two per Renyi-2 region (the swapped halves) and one
    per SMA displacement and E_loc chunk; one per <S^2> pair chunk; and
    for the fidelity the second chain's initial refresh and
    thermalization (max(therm, 50) sweeps) and four forwards."""
    from qmcnn_tpu_torch.measure import chunk_sizes
    from qmcnn_tpu_torch.train import therm_chunks

    m = m or cfg.sampler.n_walkers
    le, pair, sec, lz = chunk_sizes(vmc, m, lattice)
    sweep = cfg.sampler.sweep_size or lattice.n_sites

    def sweeps(n):
        return 1 if vmc.sampler.backend == "cuda" else n * sweep

    def thermalization(n):
        return 1 + sum(1 + sweeps(k) for _, k in therm_chunks(
            n, cfg.run.therm_sweeps_per_dispatch))

    chunks = -(-m // (le or m))
    per_sample = (1 + sweeps(sweeps_between) + chunks
                  + (chunks if lattice.basis == 1 else 0)
                  + ((vmc.ham.n_conn + 2) * (m // lz) if lanczos else 0)
                  + (2 * (m // sec) if sector else 0)
                  + 2 * regions + sma_disps * chunks)
    n_pairs = lattice.n_sites * (lattice.n_sites - 1) // 2
    return (thermalization(therm) + n_samples * per_sample
            + (-(-n_pairs // pair) if total_spin else 0)
            + (thermalization(max(therm, 50)) + 4 if fidelity else 0))


def measure_split(seconds: dict, n_samples: int, card: str,
                  label: str) -> dict:
    """Print a measurement's split: the thermalization, ms per sample of
    each estimator, <S^2> once."""
    once = ("therm", "total_spin", "fidelity_therm", "fidelity")
    per = {k: 1000 * v / n_samples for k, v in seconds.items()
           if k not in once}
    print(f"    {label} measurement ({card}): thermalization "
          f"{seconds.get('therm', 0.0):.2f} s; per sample "
          f"{sum(per.values()):.2f} ms = "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + " ms"
          + "".join(f"; {k} once {1000 * seconds[k]:.2f} ms"
                    for k in once[1:] if k in seconds))
    return {"therm_s": seconds.get("therm", 0.0), "per_sample_ms": per,
            **{f"{k}_ms": 1000 * seconds[k] for k in once[1:]
               if k in seconds}}


def measure_quiet(cfg, path: Path, **kw):
    """``qmcnn_tpu_torch.measure.measure`` on the card with its stdout
    captured and echoed: (report, text, seconds per phase from the
    spans)."""
    from qmcnn_tpu_torch.measure import PHASES, measure
    from qmcnn_tpu_torch.utils.profiling import recording

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), recording() as window:
        report = measure(cfg, str(path), device="cuda", **kw)
    sys.stdout.write(buf.getvalue())
    return report, buf.getvalue(), window.seconds(PHASES)


def lanczos_gain_check(label: str, rep: dict, traces: dict) -> dict:
    """The Lanczos step valid, its gain h1 - E_lz (h1 the moment pass's own
    E_loc mean) at most sqrt(k2), and its jackknife error finite."""
    import numpy as np

    e1 = np.concatenate(traces["lanczos_e1"])
    h1 = float(e1.real.mean())
    k2 = float((np.abs(e1) ** 2).mean()) - h1 * h1
    gain = h1 - rep["lanczos_energy"]
    check(rep["lanczos_valid"], f"{label}: the Lanczos step is invalid "
          f"(gain {gain}, sqrt(k2) {np.sqrt(max(k2, 0.0))})")
    check(gain <= np.sqrt(max(k2, 0.0)), f"{label}: Lanczos gain {gain} > "
          f"sqrt(k2) {np.sqrt(max(k2, 0.0))}")
    check(np.isfinite(rep.get("lanczos_energy_err", np.nan)),
          f"{label}: no finite Lanczos jackknife error")
    return {"gain": gain, "sqrt_k2": float(np.sqrt(max(k2, 0.0)))}


def measure_cnn_leg(card: str) -> dict:
    """(a) The heis10x10_sr fixture in its run's config at full width (10x10,
    real CNN 16^3, M = 2048, exchange), ``--total-spin --dimer
    --sector-momentum 0,0 --renyi2 half --renyi2 50:100 --renyi2 0:10
    --sma --lanczos-step --fidelity-ckpt`` the bf16 sibling run's snapshot
    (read in f32): K1 serves every sweep and forward at the expected count,
    K2 0; the energy within 0.01/site of the JAX run, magnetization
    exactly 0, the S(q) peak at (pi, pi) (index 55), the NN S.S within 0.01
    of E/site / 2, the q = 0 sector (the CNN and the Marshall-rotated state
    are translation invariant) with weight within 1e-4 of 1 and energy
    within 1e-4 |E| of the energy, <S^2> finite; ``half`` and its
    complement ``50:100`` (the same estimator: swapping B gives A's pair
    (t2, t1)) per sample within 1e-6 relative and S_2 > 0; the SMA's C_t(1)
    and C_t(10) within 0.01 of each other, its softest mode at (pi, pi)
    (index 55), its bound printed beside the JAX report of another
    heis10x10_sr state; the Lanczos step valid, its gain at most sqrt(k2),
    its jackknife error finite; the fidelity in (0, 1.05], and exactly 1
    for the fixture with itself on the leg's walkers. First, K1's
    recompute forward against the cuDNN model at the leg's new calls (the
    swap batch, M / 2; the Lanczos chunk's inner call, chunk x n_conn) and
    at the sector chunk's, log psi within rtol 1e-5."""
    import numpy as np
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.measure import chunk_sizes
    from qmcnn_tpu_torch.ops.fidelity import fidelity
    from qmcnn_tpu_torch.ops.sma import exchange_shells
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    cfg = meta_config(FIXTURE_META)
    e_jax = json.loads(FIXTURE_META.read_text())["e_per_site"]
    n = MEASURE_SAMPLES["cnn"]
    m = cfg.sampler.n_walkers
    vmc, _, lattice = build(cfg, device="cuda")
    check(isinstance(vmc.eval_log_psi_fn, k1.FusedCNNLogPsi)
          and vmc.sampler.backend == "cuda",
          "measure (a): K1 does not serve the sweeps and forwards")
    _, _, sec, lz = chunk_sizes(vmc, m, lattice)
    k = vmc.ham.n_conn
    fixture = params_from_jax(load_checkpoint_params(str(FIXTURE)), "cuda")
    for rows, seed, call in ((m // 2, 33, "swap batch"),
                             (lz * k, 34, "Lanczos chunk's inner call"),
                             (sec * k * lattice.n_sites, 32,
                              "sector chunk's call")):
        rel = recompute_rel_err(fixture, lattice, rows, seed=seed)[0]
        print(f"    (a) K1's recompute forward at the {call} B={rows}: log "
              f"psi max rel err vs the cuDNN model {rel:.3e}")
        check(rel <= 1e-5, f"measure (a): recompute forward at B={rows}: "
              f"rel err {rel}")
    disps = len({d for _, d in exchange_shells(vmc.ham, lattice)})
    want = measure_expected(cfg, vmc, lattice, n, 50, total_spin=True,
                            sector=True, lanczos=True,
                            regions=len(MEASURE_REGIONS), sma_disps=disps,
                            fidelity=True)
    record = {}
    reset_counts()
    t0 = time.perf_counter()
    rep, _, timings = measure_quiet(
        cfg, FIXTURE, n_samples=n, total_spin=True, dimer=True,
        sector_momentum=[0, 0], renyi2_region=list(MEASURE_REGIONS),
        sma=True, lanczos=True, fidelity_ckpt=str(CNN_BF16_FIXTURE),
        record=record)
    got = counts()
    wall = time.perf_counter() - t0
    e_site = rep["energy_per_site"]
    swaps = np.stack(record["traces"]["renyi2_swap"]).astype(np.float64)
    comp = float(np.abs(swaps[:, 0] - swaps[:, 1]).max()
                 / np.abs(swaps[:, 0]).min())
    ct = rep["sma_transverse_corr"]
    ref_sma = jax_report(HEIS_SMA_REPORT)
    walkers = record["walkers"]
    self_f = float(fidelity(vmc.eval_log_psi_fn, fixture, vmc.eval_log_psi_fn,
                            fixture, walkers, walkers))
    print(f"    (a) heis10x10_sr fixture, K1: {wall:.1f} s, {n} samples, "
          f"launches {got} (expected {want} on k1), E/site {e_site:.6f} +- "
          f"{rep['energy_err'] / 100:.6f} (JAX run {e_jax:.7f}), m "
          f"{rep['magnetization']}, S(q) peak {rep['structure_factor_peak']:.5f}"
          f" at {rep['structure_factor_peak_q_index']}, NN S.S "
          f"{rep['spin_spin_nn']:.6f} (E/site / 2 {e_site / 2:.6f}), "
          f"staggered m2 {rep['staggered_m2']:.6f}, xi "
          f"{rep['correlation_length']:.5f}, Binder "
          f"{rep['binder_cumulant']:.5f}, dimer S(pi, 0) "
          f"{rep['dimer_sf_pi0']:.5f}, q = 0 sector: weight "
          f"{rep['sector_weight']!r}, E_q {rep['sector_energy']!r} (E "
          f"{rep['energy']!r}), <S^2> {rep['total_spin_sq']:.5f}")
    print(f"    (a) Renyi-2 {list(MEASURE_REGIONS)}: Tr rho_A^2 "
          f"{rep['renyi2_swap_mean']} +- {rep['renyi2_swap_err']}, S_2 "
          f"{rep['renyi2_entropy']}; half vs 50:100 per sample max rel diff "
          f"{comp:.3e}; SMA C_t {ct}, gap bound {rep['sma_gap_bound']:.6f} at"
          f" {rep['sma_gap_q_index']} (JAX, another heis10x10_sr state: "
          f"C_t {ref_sma['sma_transverse_corr']}, bound "
          f"{ref_sma['sma_gap_bound']:.6f} at {ref_sma['sma_gap_q_index']});"
          f" Lanczos valid {rep['lanczos_valid']}, alpha "
          f"{rep['lanczos_alpha']:.6f}, E/site "
          f"{rep['lanczos_energy_per_site']:.7f} +- "
          f"{rep['lanczos_energy_per_site_err']:.7f}, gain/site "
          f"{rep['lanczos_gain_per_site']:.7f}; fidelity with the bf16 "
          f"sibling run {rep['fidelity_vs_ckpt']:.6f}, with itself {self_f!r}")
    check(got == {"k1": want, "k2_f32": 0, "k2_bf16": 0},
          f"measure (a): launches {got}, expected {want} on k1")
    check(abs(e_site - e_jax) <= 0.01,
          f"measure (a): E/site {e_site} not within 0.01 of {e_jax}")
    check(rep["magnetization"] == 0.0,
          f"measure (a): magnetization {rep['magnetization']}")
    check(rep["structure_factor_peak_q_index"] == 55,
          f"measure (a): S(q) peak at {rep['structure_factor_peak_q_index']}")
    check(abs(rep["spin_spin_nn"] - e_site / 2) < 0.01,
          f"measure (a): NN S.S {rep['spin_spin_nn']} vs E/site / 2")
    check(abs(rep["sector_weight"] - 1.0) < 1e-4,
          f"measure (a): q = 0 sector weight {rep['sector_weight']}")
    check(abs(rep["sector_energy"] - rep["energy"])
          < 1e-4 * abs(rep["energy"]),
          f"measure (a): E_q {rep['sector_energy']} vs E {rep['energy']}")
    check(np.isfinite(rep["total_spin_sq"]), "measure (a): <S^2> not finite")
    check(comp <= 1e-6, f"measure (a): half and 50:100 differ by {comp}")
    check(rep["renyi2_entropy"][0] > 0,
          f"measure (a): S_2(half) {rep['renyi2_entropy'][0]}")
    check(abs(ct["1"] - ct["10"]) <= 0.01, f"measure (a): C_t {ct}")
    check(rep["sma_gap_q_index"] == 55,
          f"measure (a): SMA gap at q index {rep['sma_gap_q_index']}")
    gain = lanczos_gain_check("measure (a)", rep, record["traces"])
    check(0.0 < rep["fidelity_vs_ckpt"] <= 1.05,
          f"measure (a): fidelity {rep['fidelity_vs_ckpt']}")
    check(self_f == 1.0, f"measure (a): self-fidelity {self_f!r}")
    split = measure_split(timings, n, card, "(a) heis10x10_sr")
    return {"launches": got, "report": rep, "split": split, "seconds": wall,
            "lanczos_gain": gain, "half_vs_complement": comp,
            "self_fidelity": self_f}


def measure_gcnn_kernel_checks(cfg, vmc, params, lattice) -> None:
    """K2's f32 route on the p15b snapshot's weights at the batches leg (b)
    launches it with: S_g at the sweep's call (M walkers and their spin
    flips, B = 2M), at an E_loc chunk's (le_chunk x n_conn connected
    configurations and their flips), the chunk held on its first 16,384
    rows, and at an SMA displacement chunk's (le_chunk x N and their
    flips), within the d12 fixture's rtol / atol 1e-3; and log psi through
    the evaluation forward (the character and the spin-flip projection
    included) against the plain model at M, at the E_loc chunk (held on
    its first 8,192) and at the SMA chunk, as :func:`compare_gcnn_log_psi`
    holds it."""
    import torch
    from qmcnn_tpu_torch.measure import chunk_sizes
    from qmcnn_tpu_torch.sampler.metropolis import init_walkers, prng_key

    m = cfg.sampler.n_walkers
    le = chunk_sizes(vmc, m, lattice)[0] or m
    chunk = le * vmc.ham.n_conn
    sma = le * lattice.n_sites
    mc = cfg.model
    kw = dict(lattice_shape=tuple(lattice.shape), channels=tuple(mc.channels),
              complex_params=mc.complex_params, activation=mc.activation,
              residual=mc.residual)
    label = (f"p15b snapshot (W={8 * mc.channels[0]}, L={len(mc.channels)}, "
             f"{mc.activation}, residual)")
    for batch, rows, seed, call in ((2 * m, None, 51, "sweep call"),
                                    (2 * chunk, 16384, 52, "E_loc chunk"),
                                    (2 * sma, None, 55, "SMA chunk")):
        _, ws, x, kw2 = gcnn_case(kw, batch, seed, "cuda", params=params)
        compare_gcnn(f"{label}, {call}", ws, x, kw2, 1e-3, rows=rows)
        del x
    for batch, rows, seed in ((m, m, 53), (chunk, 8192, 54), (sma, sma, 56)):
        x = init_walkers(prng_key(seed), batch, lattice.n_sites,
                         sector="sz0", device="cuda")
        with torch.no_grad():
            got = vmc.eval_log_psi_fn(params, x)[:rows]
            want = vmc.log_psi_fn(params, x[:rows])
        torch.cuda.synchronize()
        check_log_psi(f"{label} log psi, {mc.gcnn_character}, spin-flip "
                      f"{mc.spin_flip_sector:+d}, {batch} configurations "
                      f"(first {rows} held)", got, want,
                      mc.gcnn_character != "A1", 1e-4, 1e-3)
        del x


def measure_gcnn_leg(card: str) -> dict:
    """(b) The bf16-trained gcnn_r2 snapshot p15b in its run's config at full
    width (W = 80, L = 8, M = 2048), measured in f32: the override line,
    K2's f32 route on every forward at the expected count, K2 bf16 and K1
    0; against the JAX f32 report: E/site within max(0.002, 5 sigma),
    magnetization 0, the S(q) peak at index 36, the NN S.S within 0.005,
    staggered m2 within 10%; xi and the Binder cumulant printed beside
    JAX's; with ``--sma``, against the JAX SMA report of the same snapshot
    (runs/j1j2_8x8_sma.json): each of the four C_t within 0.005, the
    softest mode at (pi, pi) (index 36), the gap bound within 10%. First,
    K2 against its plain version on the snapshot's weights at the leg's
    batches (:func:`measure_gcnn_kernel_checks`)."""
    import dataclasses

    import numpy as np
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.ops.sma import exchange_shells
    from qmcnn_tpu_torch.utils.transfer import warm_start

    cfg = meta_config(P15B_META)
    ref = jax_report(P15B_REPORT)
    ref_sma = jax_report(P15B_SMA_REPORT)
    n = MEASURE_SAMPLES["gcnn"]
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    vmc, params, lattice = build(f32, device="cuda")
    check(isinstance(vmc.eval_log_psi_fn, k2.FusedLogPsi)
          and vmc.eval_log_psi_fn.compute_dtype == "float32",
          "measure (b): K2's f32 route does not serve the forwards")
    measure_gcnn_kernel_checks(f32, vmc, warm_start(params, str(P15B_FIXTURE)),
                               lattice)
    disps = len({d for _, d in exchange_shells(vmc.ham, lattice)})
    want = measure_expected(f32, vmc, lattice, n, 50, sma_disps=disps)
    reset_counts()
    t0 = time.perf_counter()
    rep, text, timings = measure_quiet(cfg, P15B_FIXTURE, n_samples=n,
                                     sma=True)
    got = counts()
    wall = time.perf_counter() - t0
    sigma = np.hypot(rep["energy_err"], ref["energy_err"]) / 64
    d_e = rep["energy_per_site"] - ref["energy_per_site"]
    print(f"    (b) j1j2_8x8_p15b (bf16-trained) in f32, K2 f32: {wall:.1f} "
          f"s, {n} samples, launches {got} (expected {want} on k2_f32), "
          f"E/site {rep['energy_per_site']:.7f} +- "
          f"{rep['energy_err'] / 64:.7f} (JAX {ref['energy_per_site']:.7f}"
          f" +- {ref['energy_err'] / 64:.7f}; diff {d_e:+.7f}, sigma "
          f"{sigma:.7f}), m {rep['magnetization']}, S(q) peak "
          f"{rep['structure_factor_peak']:.5f} at "
          f"{rep['structure_factor_peak_q_index']} (JAX "
          f"{ref['structure_factor_peak']:.5f} at "
          f"{ref['structure_factor_peak_q_index']}), NN S.S "
          f"{rep['spin_spin_nn']:.7f} (JAX {ref['spin_spin_nn']:.7f}), "
          f"staggered m2 {rep['staggered_m2']:.7f} (JAX "
          f"{ref['staggered_m2']:.7f}), xi {rep['correlation_length']:.5f} "
          f"(JAX {ref['correlation_length']:.5f}), Binder "
          f"{rep['binder_cumulant']:.5f} (JAX {ref['binder_cumulant']:.5f})")
    check("measure: forcing compute_dtype float32 (training used bfloat16)"
          in text, "measure (b): no f32 override line")
    check(got == {"k1": 0, "k2_f32": want, "k2_bf16": 0},
          f"measure (b): launches {got}, expected {want} on k2_f32")
    check(abs(d_e) <= max(0.002, 5 * sigma),
          f"measure (b): E/site off the JAX report by {d_e}")
    check(rep["magnetization"] == 0.0,
          f"measure (b): magnetization {rep['magnetization']}")
    check(rep["structure_factor_peak_q_index"]
          == ref["structure_factor_peak_q_index"] == 36,
          f"measure (b): S(q) peak at {rep['structure_factor_peak_q_index']}")
    check(abs(rep["spin_spin_nn"] - ref["spin_spin_nn"]) <= 0.005,
          f"measure (b): NN S.S {rep['spin_spin_nn']}")
    check(abs(rep["staggered_m2"] / ref["staggered_m2"] - 1) <= 0.1,
          f"measure (b): staggered m2 {rep['staggered_m2']}")
    ct, ct_ref = rep["sma_transverse_corr"], ref_sma["sma_transverse_corr"]
    ct_diff = max(abs(ct[d] - v) for d, v in ct_ref.items())
    gap_rel = rep["sma_gap_bound"] / ref_sma["sma_gap_bound"] - 1
    print(f"    (b) SMA: C_t {ct} (JAX {ct_ref}; max diff {ct_diff:.6f}), "
          f"gap bound {rep['sma_gap_bound']:.6f} at {rep['sma_gap_q_index']}"
          f" (JAX {ref_sma['sma_gap_bound']:.6f} at "
          f"{ref_sma['sma_gap_q_index']}; {100 * gap_rel:+.2f}%)")
    check(sorted(ct) == sorted(ct_ref) and ct_diff <= 0.005,
          f"measure (b): SMA C_t {ct} vs JAX {ct_ref}")
    check(rep["sma_gap_q_index"] == ref_sma["sma_gap_q_index"] == 36,
          f"measure (b): SMA gap at q index {rep['sma_gap_q_index']}")
    check(abs(gap_rel) <= 0.1, f"measure (b): SMA gap bound "
          f"{rep['sma_gap_bound']} vs JAX {ref_sma['sma_gap_bound']}")
    split = measure_split(timings, n, card, "(b) j1j2_8x8_p15b")
    return {"launches": got, "report": rep, "split": split, "seconds": wall}


def measure_cli_leg(out_dir: Path, card: str) -> dict:
    """(c) ``python -m qmcnn_tpu_torch.measure`` on the card in a subprocess:
    the kagome PhaseNet run's config (its meta.json; the port refuses
    run.heartbeat_path), its snapshot with ``--ema --chirality``: "ema"
    true, a finite chirality with its error, E/site within 0.01 of the JAX
    EMA report and its S(q) peak index; no kernel launched (PhaseNet takes
    the plain model, as in JAX)."""
    import numpy as np

    ref = jax_report(KAGOME_EXT_REPORT)
    yaml_path = out_dir / "kagome3x3_r3_phasenet_ext.yaml"
    yaml_path.write_text(json.loads(KAGOME_EXT_META.read_text())["config"])
    n = MEASURE_SAMPLES["kagome"]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "qmcnn_tpu_torch.measure", "--config",
         str(yaml_path), "--override", "run.heartbeat_path=null",
         "--ckpt-dir", str(KAGOME_EXT_FIXTURE), "--ema", "--chirality",
         "--n-samples", str(n), "--timings"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"measure (c): the CLI failed (rc "
          f"{run.returncode}):\n{run.stdout[-2000:]}{run.stderr[-3000:]}")
    out = run.stdout
    rep = json.loads(out[out.index("{\n"):out.index("\nszsz_corr:")])
    extra = json.loads(out.strip().splitlines()[-1])
    got = extra["launches"]
    d_e = rep["energy_per_site"] - ref["energy_per_site"]
    print(f"    (c) python -m qmcnn_tpu_torch.measure --ema --chirality, "
          f"kagome3x3_r3_phasenet_ext: {wall:.1f} s in all, {n} samples, "
          f"ema {rep['ema']}, launches {got}, E/site "
          f"{rep['energy_per_site']:.7f} +- {rep['energy_err'] / 27:.7f} "
          f"(JAX EMA {ref['energy_per_site']:.7f}; diff {d_e:+.7f}), S(q) "
          f"peak {rep['structure_factor_peak']:.5f} at "
          f"{rep['structure_factor_peak_q_index']} (JAX "
          f"{ref['structure_factor_peak']:.5f} at "
          f"{ref['structure_factor_peak_q_index']}), chirality "
          f"{rep['scalar_chirality']:.6f} +- {rep['scalar_chirality_err']:.6f}"
          " (the JAX report has none)")
    check(rep["ema"] is True, "measure (c): the report is not the EMA's")
    check(np.isfinite(rep["scalar_chirality"])
          and np.isfinite(rep["scalar_chirality_err"]),
          "measure (c): chirality not finite")
    check(abs(d_e) <= 0.01, f"measure (c): E/site off JAX's by {d_e}")
    check(rep["structure_factor_peak_q_index"]
          == ref["structure_factor_peak_q_index"],
          f"measure (c): S(q) peak at {rep['structure_factor_peak_q_index']}")
    check(sum(got.values()) == 0, f"measure (c): launched {got}")
    split = measure_split(extra["timings_s"], n, card,
                          "(c) kagome3x3_r3_phasenet_ext")
    return {"launches": got, "report": rep, "split": split, "seconds": wall}


def measure_lanczos_cli_leg(out_dir: Path, card: str) -> dict:
    """(c') ``python -m qmcnn_tpu_torch.measure --lanczos-step --n-samples 4
    --override sampler.n_walkers=1024`` on the kagome PhaseNet run's final
    params (its CSV ends at the JAX report's step, 3000), in the run's
    config, as JAX's Lanczos-step diagnostic of that run measured it
    (runs/kagome3x3_r3_lanczos_diag.json, scripts/r4_pipeline3.sh arm I;
    its checkpoint's full-state restore at another walker count fell back
    to the params and 50 fresh sweeps, as a .npz does): the step valid,
    E/site within max(5 sigma, 0.002) of JAX's, the Lanczos E/site within
    max(5 x its jackknife error, 0.002) of JAX's, alpha printed beside
    JAX's; no kernel (PhaseNet takes the plain model)."""
    import numpy as np

    ref = jax_report(KAGOME_LANCZOS_REPORT)
    last_step = int(KAGOME_EXT_CSV.read_text().strip().splitlines()[-1]
                    .split(",")[0])
    check(last_step == ref["step"] == 3000, f"measure (c'): the snapshot's "
          f"run ends at step {last_step}, the JAX report read {ref['step']}")
    yaml_path = out_dir / "kagome3x3_r3_phasenet_ext.yaml"
    yaml_path.write_text(json.loads(KAGOME_EXT_META.read_text())["config"])
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "qmcnn_tpu_torch.measure", "--config",
         str(yaml_path), "--override", "run.heartbeat_path=null",
         "--ckpt-dir", str(KAGOME_EXT_FIXTURE), "--lanczos-step",
         "--n-samples", "4", "--override", "sampler.n_walkers=1024",
         "--timings"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"measure (c'): the CLI failed (rc "
          f"{run.returncode}):\n{run.stdout[-2000:]}{run.stderr[-3000:]}")
    out = run.stdout
    rep = json.loads(out[out.index("{\n"):out.index("\nszsz_corr:")])
    extra = json.loads(out.strip().splitlines()[-1])
    got = extra["launches"]
    sigma = np.hypot(rep["energy_err"], ref["energy_err"]) / 27
    d_e = rep["energy_per_site"] - ref["energy_per_site"]
    d_lz = rep["lanczos_energy_per_site"] - ref["lanczos_energy_per_site"]
    lz_err = rep["lanczos_energy_per_site_err"]
    print(f"    (c') python -m qmcnn_tpu_torch.measure --lanczos-step, "
          f"kagome3x3_r3_phasenet_ext (step {last_step}), M = 1024: {wall:.1f}"
          f" s in all, 4 samples, launches {got}, E/site "
          f"{rep['energy_per_site']:.7f} +- {rep['energy_err'] / 27:.7f} (JAX"
          f" {ref['energy_per_site']:.7f} +- {ref['energy_err'] / 27:.7f}; "
          f"diff {d_e:+.7f}), Lanczos valid {rep['lanczos_valid']}, E/site "
          f"{rep['lanczos_energy_per_site']:.7f} +- {lz_err:.7f} (JAX "
          f"{ref['lanczos_energy_per_site']:.7f}; diff {d_lz:+.7f}), gain/"
          f"site {rep['lanczos_gain_per_site']:.7f} (JAX "
          f"{ref['lanczos_gain_per_site']:.7f}), alpha "
          f"{rep['lanczos_alpha']:.6f} (JAX {ref['lanczos_alpha']:.6f})")
    check(rep["lanczos_valid"], "measure (c'): the Lanczos step is invalid")
    check(abs(d_e) <= max(5 * sigma, 0.002),
          f"measure (c'): E/site off JAX's by {d_e}")
    check(abs(d_lz) <= max(5 * lz_err, 0.002),
          f"measure (c'): Lanczos E/site off JAX's by {d_lz}")
    check(sum(got.values()) == 0, f"measure (c'): launched {got}")
    split = measure_split(extra["timings_s"], 4, card,
                          "(c') kagome3x3_r3_phasenet_ext Lanczos")
    return {"launches": got, "report": rep, "split": split, "seconds": wall}


#: leg (d)'s flags: every flag of the heis10x10_sr fixture, 4 samples
SHARDED_MEASURE_FLAGS = dict(
    n_samples=4, total_spin=True, dimer=True, sector_momentum=[0, 0],
    renyi2_region=list(MEASURE_REGIONS), sma=True, lanczos=True,
    fidelity_ckpt=str(CNN_BF16_FIXTURE))


def sharded_measure_run(group) -> dict:
    """Leg (d)'s measurement on this rank of ``group`` (all walkers with no
    group): the report, the walkers after thermalization, the pooled
    per-walker arrays (Lanczos, sector), the launches and the expected
    launches for this rank's walkers."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.measure import measure
    from qmcnn_tpu_torch.ops.sma import exchange_shells

    cfg = meta_config(FIXTURE_META, ("run.distributed=true",)
                      if group is not None else ())
    m = cfg.sampler.n_walkers // (1 if group is None else group.world_size)
    vmc, _, lattice = build(cfg, device="cuda", group=group)
    want = measure_expected(
        cfg, vmc, lattice, 4, 50, total_spin=True, sector=True, lanczos=True,
        regions=len(MEASURE_REGIONS), fidelity=True, m=m,
        sma_disps=len({d for _, d in exchange_shells(vmc.ham, lattice)}))
    del vmc
    record = {}
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        report = measure(cfg, str(FIXTURE), device="cuda", group=group,
                         record=record, **SHARDED_MEASURE_FLAGS)
    seconds = time.perf_counter() - t0
    tr = record["traces"]
    return {"report": report, "walkers": record["walkers"].cpu(),
            "launches": counts(), "expected": want, "seconds": seconds,
            **{k: torch.from_numpy(np.stack(tr[k])) for k in (
                "lanczos_e1", "lanczos_g", "sector_num", "sector_den")}}


def measure_rank_main(argv) -> int:
    """One spawned rank of leg (d): ``chip_smoke.py --measure-rank R --world
    W --port P --out DIR`` joins a gloo group at tcp://localhost:P on
    cuda:0, runs :func:`sharded_measure_run` and saves it to
    DIR/rank<R>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from qmcnn_tpu_torch.parallel.mesh import walker_group

    rank, world, port, out = (int(argv[1]), int(argv[3]), int(argv[5]),
                              Path(argv[7]))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    group = walker_group(device=device)
    torch.save(sharded_measure_run(group), out / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def report_scales(report: dict, n_sites: int) -> dict:
    """The scale each difference-like report number is relative to: the
    energy for its binned error, the sector's error and gap and the
    Lanczos energy's error (per site for the per-site keys), N/2 for <S^2>
    (a cancellation of M_z^2 + N/2 against the pair sum), the swap means
    for their errors."""
    e = abs(report["energy"])
    scales = {k: e for k in ("energy_err", "sector_energy_err", "sector_gap",
                             "lanczos_energy_err")}
    scales.update({k: e / n_sites for k in (
        "lanczos_gain_per_site", "lanczos_energy_per_site_err")})
    scales["total_spin_sq"] = n_sites / 2
    if "renyi2_swap_err" in report:
        scales["renyi2_swap_err"] = report["renyi2_swap_mean"]
    return scales


def report_max_rel_diff(got: dict, want: dict, scales: dict) -> float:
    """The largest difference between two reports' numbers relative to
    max(|want|, the key's scale in ``scales``, 1e-6); infinite where their
    keys, flags or Nones differ."""
    import numpy as np

    if sorted(got) != sorted(want):
        return float("inf")
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            worst = max(worst, report_max_rel_diff(g, w, {}))
            continue
        if isinstance(w, bool):
            worst = max(worst, 0.0 if g is w else float("inf"))
            continue
        gv, wv = (np.atleast_1d(np.asarray(x, dtype=object)) for x in (g, w))
        if [v is None for v in gv] != [v is None for v in wv]:
            return float("inf")
        gv = np.asarray([v for v in gv if v is not None], np.float64)
        wv = np.asarray([v for v in wv if v is not None], np.float64)
        if gv.size:
            scale = np.abs(np.asarray(scales.get(key, 0.0), np.float64))
            worst = max(worst, float((np.abs(gv - wv) / np.maximum(
                np.maximum(np.abs(wv), scale), 1e-6)).max()))
    return worst


def measure_sharded_leg(out_dir: Path, card: str, n_ranks: int) -> dict:
    """(d) measure() sharded: ``n_ranks`` gloo ranks on cuda:0 (this script
    with ``--measure-rank``) against 1 rank in this process, the
    heis10x10_sr fixture with every flag (:data:`SHARDED_MEASURE_FLAGS`),
    4 samples: each rank's walkers after thermalization bitwise the 1-rank
    run's rows; the pooled per-walker Lanczos (E_loc, G) and sector num /
    den bitwise the 1-rank run's, or within rtol 1e-6 (reported); every
    report number within rtol 1e-5 (reduction order) of itself or of the
    scale it is a difference of (:func:`report_scales`), and the ranks'
    reports identical; K1 per rank at ``measure_expected`` for its
    walkers, K2 0. Then the CLI under torchrun with NCCL, one rank per
    card shown (NCCL refuses two ranks on one card), 1 sample of the same
    flags: rc 0, one report printed (rank 0's)."""
    import numpy as np
    import torch

    work = out_dir / "sharded_measure"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ref = sharded_measure_run(None)
    check(ref["launches"] == {"k1": ref["expected"], "k2_f32": 0,
                              "k2_bf16": 0},
          f"measure (d), 1 rank: launches {ref['launches']}, expected "
          f"{ref['expected']} on k1")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--measure-rank",
         str(r), "--world", str(n_ranks), "--port", str(port), "--out",
         str(work)], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n_ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:  # stop every rank if one failed or hung
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"measure (d): rank {r} failed "
              f"(rc {p.returncode}):\n{log[-3000:]}")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True)
             for r in range(n_ranks)]
    walkers_eq = torch.equal(torch.cat([rk["walkers"] for rk in ranks]),
                             ref["walkers"])
    arrays = {}
    for key in ("lanczos_e1", "lanczos_g", "sector_num", "sector_den"):
        bitwise = all(torch.equal(rk[key], ref[key]) for rk in ranks)
        rel = max(float(((rk[key] - ref[key]).abs()
                         / ref[key].abs().clamp_min(1e-30)).max())
                  for rk in ranks)
        arrays[key] = {"bitwise": bitwise, "max_rel_diff": rel}
    rep_diff = report_max_rel_diff(ranks[0]["report"], ref["report"],
                                   report_scales(ref["report"], 100))
    same = all(rk["report"] == ranks[0]["report"] for rk in ranks[1:])
    print(f"    (d) {n_ranks} gloo ranks on cuda:0 vs 1 rank, heis10x10_sr "
          f"with every flag, 4 samples: 1 rank {ref['seconds']:.1f} s, "
          f"{n_ranks} ranks {t_ranks:.1f} s with the process starts; K1 "
          f"per rank {[rk['launches']['k1'] for rk in ranks]} (expected "
          f"{[rk['expected'] for rk in ranks]}; 1 rank "
          f"{ref['launches']['k1']}), walkers bitwise {walkers_eq}, pooled "
          f"arrays {arrays}, report max rel diff {rep_diff:.3e}, ranks' "
          f"reports identical {same}")
    check(walkers_eq, "measure (d): the walkers after thermalization differ "
          "from the 1-rank run's")
    for r, rk in enumerate(ranks):
        check(rk["launches"] == {"k1": rk["expected"], "k2_f32": 0,
                                 "k2_bf16": 0},
              f"measure (d) rank {r}: launches {rk['launches']}, expected "
              f"{rk['expected']} on k1")
    for key, a in arrays.items():
        check(a["bitwise"] or a["max_rel_diff"] <= 1e-6,
              f"measure (d): pooled {key} off the 1-rank run's by "
              f"{a['max_rel_diff']}")
    check(same, "measure (d): the ranks' reports differ")
    check(rep_diff <= 1e-5, f"measure (d): the report is {rep_diff} off "
          "the 1-rank run's")

    n_cards = min(torch.cuda.device_count(), 4)
    flags = ["--total-spin", "--dimer", "--sector-momentum", "0,0", "--sma",
             "--lanczos-step", "--fidelity-ckpt", str(CNN_BF16_FIXTURE)]
    for region in MEASURE_REGIONS:
        flags += ["--renyi2", region]
    yaml_path = out_dir / "heis10x10_sr_fixture.yaml"
    yaml_path.write_text(json.loads(FIXTURE_META.read_text())["config"])
    t1 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n_cards}", "-m", "qmcnn_tpu_torch.measure",
         "--config", str(yaml_path), "--ckpt-dir", str(FIXTURE),
         "--n-samples", "1", "--override", "run.distributed=true",
         "--override", "run.heartbeat_path=null", *flags], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t1
    check(run.returncode == 0, f"measure (d): torchrun ({n_cards} ranks, "
          f"NCCL) failed (rc {run.returncode}):\n{run.stdout[-2000:]}"
          f"{run.stderr[-3000:]}")
    out = run.stdout
    check(out.count("szsz_corr:") == 1 and out.count('"lanczos_valid"') == 1,
          "measure (d): torchrun printed other than one report")
    cli = json.loads(out[out.index("{\n"):out.index("\nszsz_corr:")])
    print(f"    (d) torchrun --nproc_per_node={n_cards} (NCCL) -m "
          f"qmcnn_tpu_torch.measure, every flag, 1 sample: rc 0, one report, "
          f"E/site {cli['energy_per_site']:.6f}, {t_cli:.1f} s in all")
    return {"launches": ref["launches"], "seconds": ref["seconds"],
            "ranks_seconds": t_ranks, "torchrun_seconds": t_cli,
            "walkers_bitwise": walkers_eq, "arrays": arrays,
            "report_max_rel_diff": rep_diff,
            "launches_per_rank": [rk["launches"]["k1"] for rk in ranks]}


def measure_phase(out_dir: Path, card: str) -> dict:
    """The measurement entry point (``qmcnn_tpu_torch/measure.py``): (a) the
    heis10x10_sr fixture on K1 with every flag, (b) the bf16 gcnn_r2
    snapshot on K2's f32 route with the SMA, (c) the CLI with the EMA and
    the chirality on the kagome PhaseNet snapshot, (c') the CLI's Lanczos
    step on the kagome PhaseNet run's final params, (d) leg (a)'s
    measurement sharded over 2 gloo ranks against 1, and through torchrun;
    each leg's counters zeroed just before it and read just after it,
    held exactly to ``measure_expected``."""
    legs = {"cnn": measure_cnn_leg(card), "gcnn": measure_gcnn_leg(card),
            "kagome": measure_cli_leg(out_dir, card),
            "kagome_lanczos": measure_lanczos_cli_leg(out_dir, card),
            "sharded": measure_sharded_leg(out_dir, card, SHARD_RANKS)}
    out = {k: sum(leg["launches"][k] for leg in legs.values())
           for k in ("k1", "k2_f32", "k2_bf16")}
    print(json.dumps({"measure": {
        "launches": out, **{name: {"seconds": leg["seconds"],
                                   "split": leg["split"]}
                            for name, leg in legs.items() if "split" in leg},
        "sharded": legs["sharded"]}}))
    return dict(out, legs=legs)


# ---------------------------------------------------------------------------
# dynamics: python -m qmcnn_tpu_torch.evolve and analyze (slice 13)
# ---------------------------------------------------------------------------

def dynamics_expected(cfg, lattice, sampling: str, integrator: str,
                      n_steps: int, fused_sweep: bool,
                      sector_sz0: bool = False) -> int:
    """Launches of the kernel behind ``evolve()``'s evaluation forward in
    an ``n_steps`` run: per step in full-sum mode the Born weights, per
    TDVP stage log psi and one per E_loc chunk of the basis
    (``run.chunk_size``), Heun's predictor weights and, for the TFIM,
    <sigma_x>'s log psi and E_loc (unchunked); in MC mode the initial
    refresh and the thermalization (one fused sweep launch, or one per
    proposal), then per step a refresh, the sweeps, the stages' log psi
    and E_loc chunks of the walkers (Heun reuses the samples) and the
    TFIM's two."""
    import math

    stages = 2 if integrator == "heun" else 1
    sx = 2 if cfg.hamiltonian.kind == "tfim" else 0
    chunk = cfg.run.chunk_size
    if sampling == "fullsum":
        n = lattice.n_sites
        rows = math.comb(n, n // 2) if sector_sz0 else 2 ** n
    else:
        rows = cfg.sampler.n_walkers
    chunks = rows // chunk if chunk and chunk < rows else 1
    per_stage = 1 + chunks
    if sampling == "fullsum":
        return n_steps * (1 + stages * per_stage
                          + (1 if integrator == "heun" else 0) + sx)
    sweep = cfg.sampler.sweep_size or lattice.n_sites

    def sweeps(n_sweeps):
        return 1 if fused_sweep else n_sweeps * sweep

    return (1 + sweeps(cfg.sampler.n_therm_sweeps)
            + n_steps * (1 + sweeps(cfg.sampler.n_sweeps_per_step)
                         + stages * per_stage + sx))


def evolve_quiet(cfg, **kw):
    """``qmcnn_tpu_torch.evolve.evolve`` with its stdout captured, its
    phases read from the spans: (params, logger, text, seconds per
    phase)."""
    from qmcnn_tpu_torch.evolve import PHASES, evolve
    from qmcnn_tpu_torch.utils.profiling import recording

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), recording() as window:
        params, logger = evolve(cfg, **kw)
    return params, logger, buf.getvalue(), window.seconds(PHASES)


def dynamics_split(seconds: dict, n_steps: int, card: str,
                   label: str) -> dict:
    """Print a dynamics leg's split in ms per step: the weights or the
    sampling, the TDVP stages' evaluation forwards (log psi, E_loc), the
    Jacobian, the solve and the observables."""
    per = {k: 1000 * v / n_steps for k, v in seconds.items()}
    print(f"    {label} ({card}): {sum(per.values()):.2f} ms per step = "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + " ms")
    return per


def csv_columns(path: Path) -> dict:
    """A CSV's columns as float64 arrays (JAX's evolve output)."""
    import csv as csvlib

    import numpy as np

    with open(path, newline="") as f:
        rows = list(csvlib.reader(f))
    data = np.asarray(rows[1:], np.float64)
    return {name: data[:, i] for i, name in enumerate(rows[0])}


def chain12_exact(n_rows: int) -> dict:
    """The exact Schrodinger evolution under H(h = 1.2) of the chain-12
    snapshot's state (the plain model's log psi over the 4,096 states), in
    float64 on the CPU, at the times of the quench CSV's rows 1..n_rows
    (row k holds the observables of the state at (k - 1) dt, before its
    step): ``energy_re`` (conserved), ``sx`` (<sigma_x>/N) and
    ``szsz_nn`` (per bond), each [n_rows]."""
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build_lattice, build_model
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.ops import exact
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    cfg = configs.load(str(TFIM16_CONFIG), CHAIN12_OVERRIDES)
    lattice = build_lattice(cfg)
    n, bonds = lattice.n_sites, lattice.nn_bonds
    model = build_model(cfg, lattice)
    params = params_from_jax(load_checkpoint_params(str(TFIM12_FIXTURE)))
    s = torch.as_tensor(exact.all_configs(n))
    with torch.no_grad():
        lp = log_psi_apply(model, params, s)
    z = lp.re.double().numpy() + 1j * lp.im.double().numpy()
    psi = np.exp(z - z.real.max())
    psi /= np.linalg.norm(psi)
    h = exact.sparse_tfim(n, bonds, j=cfg.hamiltonian.j,
                          h=cfg.hamiltonian.h).tocsc()
    sx_op = exact.sparse_tfim(n, bonds, j=0.0, h=1.0).tocsc()
    spins = s.double().numpy()
    zz = (spins[:, bonds[:, 0]] * spins[:, bonds[:, 1]]).mean(axis=1)
    states = spla.expm_multiply(-1j * h, psi, start=0.0,
                                stop=(n_rows - 1) * 0.005, num=n_rows,
                                endpoint=True)
    return {"energy_re": np.asarray([np.real(np.vdot(v, h @ v))
                                     for v in states]),
            "sx": np.asarray([-np.real(np.vdot(v, sx_op @ v)) / n
                              for v in states]),
            "szsz_nn": np.asarray([(np.abs(v) ** 2 * zz).sum()
                                   for v in states])}


def dynamics_chain12_leg(out_dir: Path, card: str) -> dict:
    """(a) The chain-12 real-time quench, full sum, through the CLI
    (``python -m qmcnn_tpu_torch.evolve``, scripts/r2_pipeline37.sh's flags,
    362 steps from runs/tfim12_h2.csv.params.npz; the complex CNN takes the
    plain model: no kernel), against runs/tvmc_chain12_quench.csv (the
    JAX run on the TPU): row 1's energy within 2e-4 relative and sx within
    5e-4; and against the exact evolution of the same state
    (``chain12_exact``; the TPU run leaves it by 1e-2 before t = 1): row 1
    within 1e-6 relative (energy) and 1e-5 (sx, szsz_nn), sx and szsz_nn
    within 1e-3 at every t <= 1.0; the energy drift through t = 1.5 under
    0.5%; C(0) = 0.25. Then ``python -m qmcnn_tpu_torch.analyze
    --quench-spectrum --shape 12`` on the port's finite rows against the
    same number of the JAX run's (which at 362 rows give
    runs/chain12_spectrum.json's omega to 1e-9): each mode whose JAX omega
    lies within 4% of the exact one within 4% of the JAX extraction."""
    import numpy as np
    from qmcnn_tpu_torch import analyze
    from qmcnn_tpu_torch.ops.spectroscopy import (dominant_frequencies,
                                                  read_corr_csv)

    csv_path = out_dir / "tvmc_chain12_quench.csv"
    corr_path = out_dir / "tvmc_chain12_corr.csv"
    argv = [sys.executable, "-m", "qmcnn_tpu_torch.evolve", "--config",
            str(TFIM16_CONFIG)]
    for o in CHAIN12_OVERRIDES:
        argv += ["--override", o]
    argv += ["--mode", "real", "--init-from", str(TFIM12_FIXTURE), "--dt",
             "0.005", "--steps", str(CHAIN12_STEPS), "--solver", "dense",
             "--diag-shift", "0.0001", "--sampling", "fullsum", "--csv",
             str(csv_path), "--corr-csv", str(corr_path), "--log-every",
             "1", "--timings"]
    t0 = time.perf_counter()
    run = subprocess.run(argv, cwd=str(ROOT), capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"dynamics (a): the CLI failed (rc "
          f"{run.returncode}):\n{run.stdout[-2000:]}{run.stderr[-3000:]}")
    extra = json.loads(run.stdout.strip().splitlines()[-1])
    got = extra["launches"]
    port, jax_run = csv_columns(csv_path), csv_columns(CHAIN12_QUENCH)
    steps = len(port["t"])
    e, e_j = port["energy_re"], jax_run["energy_re"]
    finite = np.isfinite(e)
    blowup = (float(port["t"][np.argmin(finite)]) if not finite.all()
              else None)
    # the JAX run was written on the TPU, whose f32 products lose bits:
    # its row 1 (the snapshot's own full sum) sits 1.5e-4 (energy), 2.5e-4
    # (sx) and 5.0e-4 (szsz_nn) off the float64 value, which the JAX
    # package gives on the CPU, and its sx and szsz_nn leave the exact
    # evolution by 9e-3 and 1.1e-2 before t = 1, where the JAX package on
    # the CPU stays within 1.3e-4 (tests/torch_quench_reference.py). So
    # rows to t = 1.0 are held to the exact evolution, and the TPU run's
    # differences are printed
    ex = chain12_exact(CHAIN12_STEPS)
    d_f64 = {k: abs(port[k][0] - ex[k][0])
             / (abs(ex[k][0]) if k == "energy_re" else 1.0)
             for k in ("energy_re", "sx", "szsz_nn")}
    d_row1 = {"energy_re": abs(e[0] - e_j[0]) / abs(e_j[0]),
              "sx": abs(port["sx"][0] - jax_run["sx"][0]),
              "szsz_nn": abs(port["szsz_nn"][0] - jax_run["szsz_nn"][0])}
    early = port["t"] <= 1.0 + 1e-9
    n_early = int(early.sum())
    d_sx = float(np.abs(port["sx"][early] - ex["sx"][:n_early]).max())
    d_zz = float(np.abs(port["szsz_nn"][early]
                        - ex["szsz_nn"][:n_early]).max())
    d_sx_j = float(np.abs(port["sx"][early] - jax_run["sx"][:n_early]).max())
    d_zz_j = float(np.abs(port["szsz_nn"][early]
                          - jax_run["szsz_nn"][:n_early]).max())
    tpu_off = [float(np.abs(jax_run[k][:n_early] - ex[k][:n_early]).max())
               for k in ("sx", "szsz_nn")]
    upto = port["t"] <= 1.5 + 1e-9
    drift = float(np.abs(e[upto] - e[0]).max() / abs(e[0]))
    drift_j = float(np.abs(e_j[:int(upto.sum())] - e_j[0]).max()
                    / abs(e_j[0]))
    print(f"    (a) python -m qmcnn_tpu_torch.evolve, chain-12 real-time "
          f"quench h 2 -> 1.2, full sum: {wall:.1f} s in all ("
          f"{steps} rows), launches {got}; row 1 energy {e[0]:.6f} (JAX "
          f"{e_j[0]:.6f}, rel {d_row1['energy_re']:.2e}; float64 on the "
          f"CPU {ex['energy_re'][0]:.6f}), sx {port['sx'][0]:.6f} (JAX "
          f"{jax_run['sx'][0]:.6f}, float64 {ex['sx'][0]:.6f}), szsz_nn "
          f"{port['szsz_nn'][0]:.6f} (JAX {jax_run['szsz_nn'][0]:.6f}, "
          f"float64 {ex['szsz_nn'][0]:.6f}); over {n_early} rows to t = "
          f"1.0 max |d sx|, |d szsz| {d_sx:.2e}, {d_zz:.2e} from the exact "
          f"evolution ({d_sx_j:.2e}, {d_zz_j:.2e} from the TPU run's, "
          f"which is {tpu_off[0]:.2e}, {tpu_off[1]:.2e} from the exact "
          f"one); energy drift to "
          f"t = 1.5 {100 * drift:.3f}% (JAX {100 * drift_j:.3f}%); "
          f"tdvp_error max {np.nanmax(port['tdvp_error']):.2e}; non-finite "
          f"from t = {blowup} (JAX: t = 1.815)")
    check(sum(got.values()) == 0, f"dynamics (a): launched {got}")
    check(d_row1["energy_re"] <= 2e-4, f"dynamics (a): row 1 energy "
          f"{e[0]} vs JAX {e_j[0]}")
    check(d_row1["sx"] <= 5e-4, f"dynamics (a): row 1 sx off JAX's: "
          f"{d_row1}")
    check(d_f64["energy_re"] <= 1e-6 and d_f64["sx"] <= 1e-5
          and d_f64["szsz_nn"] <= 1e-5,
          f"dynamics (a): row 1 off its float64 value: {d_f64}")
    check(n_early == 200, f"dynamics (a): {n_early} rows to t = 1.0")
    check(d_sx <= 1e-3 and d_zz <= 1e-3, f"dynamics (a): sx / szsz_nn "
          f"off the exact evolution by {d_sx} / {d_zz} before t = 1.0")
    check(int(upto.sum()) == 300 and drift < 5e-3,
          f"dynamics (a): energy drift {drift} through t = 1.5 "
          f"({int(upto.sum())} rows)")
    with open(corr_path) as f:
        head, row1 = f.readline(), f.readline()
    check(head.strip().split(",")[1:] == [f"c{r}" for r in range(12)],
          f"dynamics (a): corr header {head!r}")
    check(abs(float(row1.split(",")[1]) - 0.25) <= 1e-6,
          f"dynamics (a): C(0) {row1.split(',')[1]}")

    # the spectrum: the CLI on the port's finite rows, the JAX run's
    # history cut to as many rows
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        table = analyze.main([str(corr_path), "--quench-spectrum",
                              "--shape", "12"])
    sys.stdout.write("      " + buf.getvalue().replace("\n", "\n      ")
                     .rstrip() + "\n")
    rows = len(read_corr_csv(str(corr_path))[0])
    t_j, c_j = read_corr_csv(str(CHAIN12_CORR))
    ref = json.loads(CHAIN12_SPECTRUM.read_text())
    full = {tuple(d["k"]): d["omega"]
            for d in dominant_frequencies(t_j[:ref["rows"]],
                                          c_j[:ref["rows"]], (12,))}
    d_json = max(abs(full[tuple(m["k"])] - m["omega"])
                 for m in ref["modes"])
    jax_at = {tuple(d["k"]): d["omega"]
              for d in dominant_frequencies(t_j[:rows], c_j[:rows], (12,))}
    port_at = {tuple(d["k"]): d["omega"] for d in table}
    modes = []
    for m in ref["modes"]:
        k = tuple(m["k"])
        gated = abs(m["omega"] - m["omega_exact"]) <= 0.04 * m["omega_exact"]
        dev = abs(port_at[k] - jax_at[k]) / jax_at[k]
        modes.append({"k": k[0], "omega": port_at[k], "jax": jax_at[k],
                      "exact": m["omega_exact"], "rel": dev,
                      "gated": gated})
        print(f"      k={k[0]}: omega {port_at[k]:.4f}, JAX at {rows} rows "
              f"{jax_at[k]:.4f} (rel {dev:.2e}), exact "
              f"{m['omega_exact']:.4f}" + ("" if gated else
                                           " (printed, not gated)"))
    check(d_json <= 1e-9, f"dynamics (a): the JAX extraction at "
          f"{ref['rows']} rows is off chain12_spectrum.json by {d_json}")
    check(sum(m["gated"] for m in modes) == 6,
          f"dynamics (a): {sum(m['gated'] for m in modes)} gated modes")
    bad = [m for m in modes if m["gated"] and m["rel"] > 0.04]
    check(not bad, f"dynamics (a): omega off JAX's by > 4%: {bad}")
    split = dynamics_split(extra["timings_s"], steps, card,
                           "(a) chain-12 quench, ms per step")
    return {"launches": got, "seconds": wall, "split": split,
            "rows": rows, "blowup_t": blowup, "drift": drift,
            "d_sx": d_sx, "d_szsz": d_zz, "d_sx_tpu": d_sx_j,
            "d_szsz_tpu": d_zz_j, "row1": d_row1, "row1_f64": d_f64,
            "modes": modes}


def k1_tfim16_check(cfg, card: str) -> dict:
    """K1's recompute forward against the plain model (cuDNN, TF32 off) on
    the card at leg (b)'s two batch shapes, the 65,536 basis states and the
    1,048,576 connected rows of E_loc: log psi within rtol 1e-5 at weights
    of scale 0.2 (log psi of order 1), and both times. At the leg's own
    fresh init (scale 0.05) log psi is 2e-4 to 2e-3, a sum of 192 lncosh
    terms that both versions compute as |x| - log 2 + log1p(e^{-2|x|})
    in f32, so its error is absolute (ulps of log 2): printed there, and
    the leg's step 1 is held to the CPU's instead."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import (build_hamiltonian, build_lattice,
                                         build_model)
    from qmcnn_tpu_torch.kernels.metropolis_sweep import FusedCNNLogPsi
    from qmcnn_tpu_torch.models.cnn import log_psi_apply
    from qmcnn_tpu_torch.ops.tdvp import all_states

    lattice = build_lattice(cfg)
    model = build_model(cfg, lattice)
    fused = FusedCNNLogPsi(lattice_shape=tuple(lattice.shape))
    basis = torch.as_tensor(all_states(lattice.n_sites), device="cuda")
    conn = build_hamiltonian(cfg, lattice).connected_batch(basis)[0]
    scaled = configs.apply_overrides(cfg, ("model.param_scale=0.2",))
    weights = {"scale 0.2": build_model(scaled, lattice).init(
                   cfg.run.seed, device="cuda"),
               "the leg's init": model.init(cfg.run.seed, device="cuda")}
    out = {}
    for name, x in (("basis", basis),
                    ("e_loc", conn.reshape(-1, lattice.n_sites))):
        errs = {}
        for label, params in weights.items():
            with torch.no_grad():
                got = fused(params, x).re.double()
                want = log_psi_apply(model, params, x).re.double()
            errs[label] = (float(((got - want).abs() / want.abs()).max()),
                           float((got - want).abs().max()),
                           float(want.abs().max()))
        params = weights["scale 0.2"]
        ms = cuda_ms(lambda: fused(params, x), reps=3)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: log_psi_apply(model, params, x),
                               reps=3)
        print(f"    K1 recompute vs the plain model at {x.shape[0]:,} rows "
              f"({card}): " + "; ".join(
                  f"{k}: max rel err {r:.3e}, max abs {a:.3e} (|log psi| "
                  f"<= {m:.3g})" for k, (r, a, m) in errs.items())
              + f"; kernel {ms:.4f} ms, cuDNN model (TF32 off) "
              f"{plain_ms:.4f} ms")
        rel = errs["scale 0.2"][0]
        check(np.isfinite(rel) and rel <= 1e-5,
              f"K1 at {x.shape[0]} tfim16 rows: rel err {rel}")
        out[name] = {"rows": int(x.shape[0]), "max_rel_err": rel,
                     "init_max_abs_err": errs["the leg's init"][1],
                     "ms": ms, "plain_ms": plain_ms}
    return out


def flat_params(params):
    import torch

    return torch.cat([params[k].reshape(-1).double().cpu()
                      for k in sorted(params)])


def dynamics_tfim16_leg(card: str) -> dict:
    """(b) tfim16_sgd at full width (N = 16, C = [12, 12], k = 5) in
    imaginary time, full sum over 65,536 states, dense solve at diag_shift
    1e-2, 40 Heun steps of 0.05 from the fresh init: K1's recompute
    forward serves every
    evaluation forward, at ``dynamics_expected``'s count (8 per step), K2
    0; the energy never rises (slack 1e-6 relative), epsilon^2 in [0, 1],
    the final energy printed beside ED. First K1 is held to the plain model
    at the leg's shapes, and step 1 on the card to the same step on the CPU
    (plain model): the energy within 1e-6 relative, the update at cosine
    >= 0.999 with a norm ratio within 1%."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build_lattice, build_model

    cfg = configs.load(str(TFIM16_CONFIG))
    lattice = build_lattice(cfg)
    # diag_shift 1e-2: at the default 1e-4 (and at 1e-3 from the JAX
    # package's init) the first Heun step from the near-product init
    # meets a nearly singular S and overshoots, in both packages; at 1e-2
    # both descend every step (tests/torch_ite_shift_scan.py)
    kw = dict(mode="imag", dt=0.05, sampling="fullsum", solver="dense",
              integrator="heun", diag_shift=1e-2)
    k1 = k1_tfim16_check(cfg, card)
    p0 = build_model(cfg, lattice).init(cfg.run.seed)
    t0 = time.perf_counter()
    p_cpu, log_cpu, _, _ = evolve_quiet(cfg, n_steps=1, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    p_gpu, log_gpu, _, _ = evolve_quiet(cfg, n_steps=1, device="cuda", **kw)
    d_cpu = flat_params(p_cpu) - flat_params(p0)
    d_gpu = flat_params(p_gpu) - flat_params(p0)
    cos = float(d_gpu @ d_cpu / (d_gpu.norm() * d_cpu.norm()))
    ratio = float(d_gpu.norm() / d_cpu.norm())
    e1_gpu = log_gpu.history["energy_re"][0]
    e1_cpu = log_cpu.history["energy_re"][0]
    print(f"    (b) step 1, card vs CPU ({cpu_s:.1f} s on the CPU): energy "
          f"{e1_gpu:.7f} vs {e1_cpu:.7f}, update cosine {cos:.7f}, norm "
          f"ratio {ratio:.6f}")
    check(abs(e1_gpu - e1_cpu) <= 1e-6 * abs(e1_cpu),
          f"dynamics (b): step-1 energy {e1_gpu} vs the CPU's {e1_cpu}")
    check(cos >= 0.999 and abs(ratio - 1.0) <= 0.01,
          f"dynamics (b): step-1 update cosine {cos}, norm ratio {ratio}")
    n_steps = 40
    want = dynamics_expected(cfg, lattice, "fullsum", "heun", n_steps,
                             fused_sweep=True)
    reset_counts()
    t0 = time.perf_counter()
    _, logger, _, timings = evolve_quiet(cfg, n_steps=n_steps, device="cuda",
                                       **kw)
    wall = time.perf_counter() - t0
    got = counts()
    h = logger.history
    e = np.asarray(h["energy_re"])
    err = np.asarray(h["tdvp_error"])
    rises = np.diff(e) - 1e-6 * np.abs(e[1:])
    rel_ed = abs(e[-1] - E_TFIM16_ED) / abs(E_TFIM16_ED)
    print(f"    (b) tfim16_sgd imaginary time, full sum (65,536 states), "
          f"{n_steps} Heun steps of 0.05: {wall:.1f} s, launches {got} "
          f"(K1 expected {want}), energy {e[0]:.6f} -> {e[-1]:.6f} (ED "
          f"{E_TFIM16_ED}; rel {rel_ed:.2e}), tdvp_error "
          f"{err.min():.2e}-{err.max():.2e}, largest step "
          f"{float(np.diff(e).max()):.2e}; E by step "
          f"{np.round(e, 4).tolist()}")
    check(got["k1"] == want and got["k2_f32"] == got["k2_bf16"] == 0,
          f"dynamics (b): launches {got}, K1 expected {want}")
    check(np.isfinite(e).all() and bool((rises <= 0).all()),
          f"dynamics (b): the energy rose: {np.diff(e).max()}")
    check(bool(((err >= 0) & (err <= 1)).all()),
          f"dynamics (b): tdvp_error outside [0, 1]: {err}")
    split = dynamics_split(timings, n_steps, card,
                           "(b) tfim16 imaginary time, ms per step")
    return {"launches": got, "expected_k1": want, "seconds": wall,
            "split": split, "k1_check": k1, "step1_cosine": cos,
            "step1_norm_ratio": ratio, "e_final": float(e[-1]),
            "cpu_step_s": cpu_s}


def dynamics_tfim8x8_leg(out_dir: Path, card: str) -> dict:
    """(c) The 8x8 TFIM real-time quench h 3 -> 1.5 in MC mode
    (scripts/r3_pipeline3g.sh's flags on its run's config, M = 2,048, 50
    thermalization sweeps, 20 Heun steps of 0.0025 from
    runs/tfim8x8_h3w2g.csv.params.npz; the complex CNN takes the plain
    model and the torch sweep: no kernel) against rows 1-20 of
    runs/tvmc_tfim8x8_quench_w2f.csv: the 20-step means of e_per_site, sx
    and szsz_nn within 0.01; epsilon^2 < 0.05 and the solver residual
    < 0.1 every step; |mean E_im| under 3 binned stderr; the corr CSV's 64
    columns with C(0) = 0.25."""
    import numpy as np
    from qmcnn_tpu_torch.utils.metrics import binned_stderr

    cfg = meta_config(TFIM8X8_META, ("hamiltonian.h=1.5",))
    corr_path = out_dir / "tvmc_tfim8x8_corr.csv"
    n_steps = 20
    reset_counts()
    t0 = time.perf_counter()
    _, logger, _, timings = evolve_quiet(
        cfg, mode="real", dt=0.0025, n_steps=n_steps, diag_shift=0.01,
        sampling="mc", init_from=str(TFIM8X8_FIXTURE),
        corr_csv=str(corr_path), device="cuda")
    wall = time.perf_counter() - t0
    got = counts()
    h = {k: np.asarray(v) for k, v in logger.history.items()}
    ref = csv_columns(TFIM8X8_QUENCH)
    means = {k: (float(h[k].mean()), float(ref[k][:n_steps].mean()))
             for k in ("e_per_site", "sx", "szsz_nn")}
    e_im = float(h["energy_im"].mean())
    e_im_err = binned_stderr(h["energy_im"])
    print(f"    (c) tfim8x8 real-time quench h 3 -> 1.5, MC (M = "
          f"{cfg.sampler.n_walkers}): {wall:.1f} s, launches {got}; 20-step "
          "means (port, JAX) " + ", ".join(
              f"{k} {a:.6f} / {b:.6f}" for k, (a, b) in means.items())
          + f"; tdvp_error max {h['tdvp_error'].max():.2e} (JAX "
          f"{ref['tdvp_error'][:n_steps].max():.2e}), solver_residual max "
          f"{h['solver_residual'].max():.2e} (JAX "
          f"{ref['solver_residual'][:n_steps].max():.2e}); mean E_im "
          f"{e_im:.5f} vs 3 x binned stderr {3 * e_im_err:.5f}")
    check(sum(got.values()) == 0, f"dynamics (c): launched {got}")
    check(len(h["t"]) == n_steps and np.isfinite(h["energy_re"]).all(),
          "dynamics (c): missing or non-finite rows")
    for k, (a, b) in means.items():
        check(abs(a - b) <= 0.01, f"dynamics (c): mean {k} {a} vs JAX {b}")
    check(bool((h["tdvp_error"] < 0.05).all()),
          f"dynamics (c): tdvp_error {h['tdvp_error'].max()}")
    check(bool((h["solver_residual"] < 0.1).all()),
          f"dynamics (c): solver residual {h['solver_residual'].max()}")
    check(abs(e_im) < 3 * e_im_err, f"dynamics (c): |mean E_im| {e_im} >= "
          f"3 stderr {e_im_err}")
    corr = csv_columns(corr_path)
    check(len(corr) == 65 and bool((np.abs(corr["c0"] - 0.25) <= 1e-6)
                                   .all()),
          f"dynamics (c): corr CSV columns {len(corr)}, C(0) {corr['c0']}")
    split = dynamics_split(timings, n_steps, card,
                           "(c) tfim8x8 quench, ms per step")
    return {"launches": got, "seconds": wall, "split": split,
            "means": means, "e_im": e_im, "e_im_err": e_im_err}


def dynamics_heis_leg(card: str) -> dict:
    """(d) heis10x10_sr in imaginary time in MC mode from the fixture, in
    its run's config (M = 2,048, exchange, 100 thermalization sweeps,
    minSR, 5 Heun steps of 0.01, diag_shift 1e-3): K1's fused sweep and
    recompute forward serve every sweep and evaluation forward at
    ``dynamics_expected``'s count, the torch proposal loop never runs, K2
    0; the 5-step mean E/site within 0.01 of the fixture's JAX run;
    epsilon^2 finite and in [0, 1]."""
    import numpy as np
    from qmcnn_tpu_torch.builder import build_lattice
    from qmcnn_tpu_torch.sampler.metropolis import MetropolisSampler

    cfg = meta_config(FIXTURE_META)
    lattice = build_lattice(cfg)
    n_steps = 5
    want = dynamics_expected(cfg, lattice, "mc", "heun", n_steps,
                             fused_sweep=True)
    proposals = []
    plain_step = MetropolisSampler._proposal_step

    def counted_step(self, *args, **kwargs):
        proposals.append(1)
        return plain_step(self, *args, **kwargs)

    MetropolisSampler._proposal_step = counted_step
    reset_counts()
    t0 = time.perf_counter()
    try:
        _, logger, _, timings = evolve_quiet(
            cfg, mode="imag", dt=0.01, n_steps=n_steps, diag_shift=1e-3,
            sampling="mc", init_from=str(FIXTURE), device="cuda")
    finally:
        MetropolisSampler._proposal_step = plain_step
    wall = time.perf_counter() - t0
    got = counts()
    h = {k: np.asarray(v) for k, v in logger.history.items()}
    e_site = float(h["e_per_site"].mean())
    print(f"    (d) heis10x10_sr imaginary time, MC from the fixture: "
          f"{wall:.1f} s, launches {got} (K1 expected {want}), torch "
          f"proposals {len(proposals)}, E/site {h['e_per_site'].tolist()} "
          f"mean {e_site:.6f} (JAX run {E_SITE_FIXTURE}), tdvp_error "
          f"{h['tdvp_error'].tolist()}")
    check(got["k1"] == want and got["k2_f32"] == got["k2_bf16"] == 0,
          f"dynamics (d): launches {got}, K1 expected {want}")
    check(not proposals, f"dynamics (d): the torch proposal loop ran "
          f"{len(proposals)} times")
    check(abs(e_site - E_SITE_FIXTURE) <= 0.01,
          f"dynamics (d): mean E/site {e_site} vs {E_SITE_FIXTURE}")
    err = h["tdvp_error"]
    check(bool((np.isfinite(err) & (err >= 0) & (err <= 1)).all()),
          f"dynamics (d): tdvp_error {err}")
    split = dynamics_split(timings, n_steps, card,
                           "(d) heis10x10_sr imaginary time, ms per step")
    return {"launches": got, "expected_k1": want, "seconds": wall,
            "split": split, "e_site": e_site}


def dynamics_phase(out_dir: Path, card: str) -> dict:
    """The dynamics entry points (``qmcnn_tpu_torch/evolve.py``,
    ``analyze.py``): (a) the chain-12 quench and its spectrum through the
    CLIs, (b) tfim16 imaginary time on K1, (c) the 8x8 MC quench, (d)
    heis10x10_sr imaginary time on K1's fused sweep; each leg's counters
    zeroed just before it and read just after it."""
    legs = {"chain12": dynamics_chain12_leg(out_dir, card),
            "tfim16": dynamics_tfim16_leg(card),
            "tfim8x8": dynamics_tfim8x8_leg(out_dir, card),
            "heis10x10": dynamics_heis_leg(card)}
    out = {k: sum(leg["launches"][k] for leg in legs.values())
           for k in ("k1", "k2_f32", "k2_bf16")}
    print(json.dumps({"dynamics": {
        "launches": out, **{name: {k: leg[k] for k in ("seconds", "split",
                                                        "launches")}
                            for name, leg in legs.items()},
        "k1_check": legs["tfim16"]["k1_check"],
        "chain12_blowup_t": legs["chain12"]["blowup_t"]}}))
    return dict(out, legs=legs)


def connected_gain(cfg, state):
    """Per walker, max over its H-connected configurations s' of
    Re log psi(s') - Re log psi(s) at the state's params: under |psi|^2 a
    gain g has probability below n_conn e^(-2g), so a large one marks a
    walker the Metropolis moves have left trapped."""
    import torch
    from qmcnn_tpu_torch.builder import build

    vmc = build(cfg, device="cuda")[0]
    s = state.walkers.s
    with torch.no_grad():
        lp = vmc.eval_log_psi_fn(state.params, s).re
        sp, _, mask = vmc.ham.connected_batch(s)
        lpp = vmc.eval_log_psi_fn(state.params, sp.reshape(-1, s.shape[1])
                                  ).re.reshape(mask.shape)
    gain = torch.where(mask, lpp - lp[:, None], torch.full_like(lpp, -1e30))
    return gain.max(dim=1).values.cpu().numpy()


def sector_step_parity(cfg, state, m: int = 32) -> None:
    """One sector step's estimator and SPRING-minSR solve from the leg's
    final params, delta and first ``m`` walkers, on the card
    and through the plain CPU path: E_q, var(e_eff) and the sector weight
    within rtol 1e-4, the natural gradient and SPRING's carry within 1e-3
    of their largest entries (float32 Cholesky solves in another order)."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.sampler.metropolis import WalkerState
    from qmcnn_tpu_torch.sr import ravel
    from qmcnn_tpu_torch.vmc import sector_energy_and_grad

    def one_step(device):
        vmc = build(cfg, device=device)[0]
        params = {k: v.to(device) for k, v in state.params.items()}
        s = state.walkers.s[:m].to(device)
        zeros = torch.zeros(m, dtype=torch.int32, device=device)
        with torch.no_grad():
            lp = vmc.log_psi_fn(params, s)
        e_q, var, grads, eff, weight = sector_energy_and_grad(
            vmc.log_psi_fn, vmc.ham, params, WalkerState(s, lp, zeros, zeros),
            vmc.lattice_shape, vmc.sector_momentum, kappa=vmc.sector_kappa,
            chunk_size=vmc.chunk_size, eval_log_psi_fn=vmc.eval_log_psi_fn)
        nat, _, _, carry = vmc.sr.solve_spring(
            vmc.log_psi_fn, params, s, grads, state.step,
            state.sr_aux.to(device), e_loc=eff)
        return ([float(e_q.re), float(var), float(weight)],
                ravel(nat)[0].cpu().numpy(), carry.cpu().numpy())

    (card, nat_c, carry_c), (plain, nat_p, carry_p) = (one_step("cuda"),
                                                       one_step("cpu"))
    err_nat = float(np.abs(nat_c - nat_p).max() / np.abs(nat_p).max())
    err_carry = float(np.abs(carry_c - carry_p).max()
                      / np.abs(carry_p).max())
    print(f"    sector step on {m} walkers, card / CPU: (E_q, var(e_eff), "
          f"weight) {card} / {plain}; natural gradient and carry within "
          f"{err_nat:.2e} and {err_carry:.2e} of their largest entries")
    check(np.allclose(card, plain, rtol=1e-4, atol=0.0),
          f"sector: the step on the card {card} is not the CPU's {plain}")
    check(err_nat < 1e-3 and err_carry < 1e-3,
          f"sector: natural gradient / carry off by {err_nat} / {err_carry}")


def fixture_log(cfg) -> dict:
    """The columns of a leg's CSV as lists of floats."""
    import csv as csvlib

    with open(cfg.run.csv_path, newline="") as f:
        rows = list(csvlib.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


SHARD_RANKS = 2


def dryrun_config(n_ranks: int, solver: str):
    """The MULTICHIP_r05.json dryrun's shape (``__graft_entry__.py``): the
    4x4 Heisenberg CNN C=(4,4), exchange moves, 4 walkers per rank, pcg
    with cg_maxiter 20 (or cg), 2 thermalization sweeps, 1 step."""
    from qmcnn_tpu_torch import configs as c

    return c.Config(
        name="dryrun", lattice=c.LatticeConfig(shape=(4, 4)),
        model=c.ModelConfig(channels=(4, 4), kernel_size=3),
        hamiltonian=c.HamiltonianConfig(kind="heisenberg"),
        sampler=c.SamplerConfig(n_walkers=4 * n_ranks, move="exchange",
                                n_sweeps_per_step=1, n_therm_sweeps=2),
        sr=c.SRConfig(enabled=True, solver=solver, cg_maxiter=20),
        run=c.RunConfig(n_steps=1))


def sharded_configs(n_ranks: int) -> dict:
    """The sharded legs' configs: (a) heis10x10_sr at full width from the
    fixture (the config's 100 thermalization sweeps, 2 steps), (b)
    j1j2_8x8_gcnn at full width with each minSR assembly (4 sweeps, 2
    steps), (c) the dryrun shape with pcg and with cg, (d) heis10x10_sr
    tempered (20 sweeps, 2 steps; and 4 sweeps, 2 steps, held by
    :func:`pcg_split_gate`) and the 4x4 E1 deflation (20 sweeps, 2 steps;
    the frozen batch drawn whole on every rank)."""
    from qmcnn_tpu_torch import configs

    heis = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"), (
        f"run.init_from={FIXTURE}", "run.n_steps=2"))
    gcnn = {a: configs.load(str(GCNN_CONFIG), (
        "sampler.n_therm_sweeps=4", "run.n_steps=2",
        f"sr.minsr_assembly={a}")) for a in ("gather", "ring")}
    return {"heis10x10_sr": heis, "gcnn_gather": gcnn["gather"],
            "gcnn_ring": gcnn["ring"],
            "dryrun_pcg": dryrun_config(n_ranks, "pcg"),
            "dryrun_cg": dryrun_config(n_ranks, "cg"),
            "tempering": tempering_config(ROOT / ".runs", n_steps=2),
            "tempering4": tempering_config(ROOT / ".runs", n_steps=2,
                                           n_therm=4),
            "defl4x4": defl4_config(ROOT / ".runs", 2, (
                "sampler.n_therm_sweeps=20", "run.csv_path=null"))}


def shard_leg(cfg, group) -> dict:
    """``cfg`` trained as train() does it, on this rank's walkers (``group``)
    or on all (None), the launch counters zeroed just before and read just
    after (the frozen batches' draw in the build stays out): walkers (all
    tempering replicas) after thermalization and after each step's
    sampling, params, the EMA, SPRING's carry and metrics after each step,
    and the launches beside ``expected_launches`` at this rank's walker
    count."""
    import torch
    from qmcnn_tpu_torch.builder import build, build_sharded
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.train import chunked_thermalize
    from qmcnn_tpu_torch.utils.transfer import warm_start

    m = cfg.sampler.n_walkers
    if group is None:
        vmc, params, _ = build(cfg, device="cuda")
    else:
        sharded, params, _ = build_sharded(cfg, group)
        vmc = sharded.vmc
    if cfg.run.init_from:
        params = warm_start(params, cfg.run.init_from)
    m_local = m if group is None else m // group.world_size
    want = expected_launches(cfg, vmc, m_local)
    want["run"] -= want["draw"]
    key = prng_key(cfg.run.seed + 100)
    reset_counts()
    if group is None:
        state = vmc.init_state(fold_in(key, 0), m, params, device="cuda")
        ids = torch.arange(m, device="cuda")
    else:
        state = sharded.init_state(fold_in(key, 0), m, params)
        ids = sharded.local_ids(state)
    state = chunked_thermalize(vmc, state, fold_in(key, 1), ids,
                               cfg.sampler.n_therm_sweeps,
                               cfg.run.therm_sweeps_per_dispatch)
    rec = {"s_therm": state.walkers.s.cpu(), "steps": [],
           "params0": {k: v.cpu() for k, v in state.params.items()}}
    base_key = fold_in(key, 2)
    for _ in range(cfg.run.n_steps):
        state, mt = vmc.step(state, fold_in(base_key, state.step), ids)
        rec["steps"].append({
            "s": state.walkers.s.cpu(),
            "params": {k: v.cpu() for k, v in state.params.items()},
            "ema": ({} if state.ema is None
                    else {k: v.cpu() for k, v in state.ema.items()}),
            "sr_aux": (torch.zeros(0) if state.sr_aux is None
                       else state.sr_aux.cpu()),
            "energy_re": float(mt.energy_re), "accept": float(mt.accept_rate),
            "overlap": float(mt.overlap), "sr_iters": int(mt.sr_iters)})
    torch.cuda.synchronize()
    rec.update(launches=counts(), expected=want["run"],
               fused=type(vmc.eval_log_psi_fn).__name__,
               backend=vmc.sampler.backend)
    return rec, vmc, state


def pcg_split_gate(name: str, want: dict, got: list) -> dict:
    """What walker sharding allows the tempered heis10x10_sr leg after 4
    sweeps (``want``: the 1-rank record; ``got``: the ranks'), where pcg's
    solve moves by reduction order and its iteration count may split.

    2 ranks take every walker mean as a mean of two half-means, so the
    energy E rounds otherwise (by ~1e-5 of 67), which moves the gradient
    b = Re mean(O* (E_loc - E)) by -dE <O> since the scores O are not
    centered (|<O>| ~ 300 here; the JAX package forms b the same way,
    E_loc centered by the all-reduced mean, ``qmcnn_tpu/vmc.py:182``, and
    the loss mean(Re[dE* log psi]) differentiated at :196-201); the S
    matvec's mean rounds otherwise too, and pcg (cg_tol 1e-4, 70-100
    iterations here) carries both until the loops stop apart, far from
    the threshold atol2 = (tol |b|)^2. ``python tests/torch_pcg_margins.py
    --device cuda:0 --walkers 2048 --split-mean`` printed on an H100 80GB
    HBM3 at 700 W: E -67.00532532 / -67.00534058, |<O>| 282.4, b_2 - b_1
    at 4.7e-3 of |b| with cosine 0.99986 and norm ratio 0.987 against
    -dE <O>; sr_iters 73 / 74 at step 1 (1 rank stops at k = 73 with
    (rr - atol2) / atol2 = -0.21, where 2 ranks read +0.86, then stop at
    74 with -0.25) and 94 / 95 at step 2 (-0.22 against +4.05, then
    -0.06); the 1-rank run whose matvec alone takes two half-means reads
    73 / 76, its rr parting at 1e-6 at k = 3 and 35% at k = 5, while a
    repeat of the 1-rank run is bitwise. The params land 2.6e-5 / 3.2e-5
    from the 1-rank run's, outside the rtol 2e-4 / atol 2e-6 the other
    legs hold (the 20-sweep leg's solve moves as well, less).

    Held: the walkers bitwise after thermalization and after step 1's
    sampling (before any pcg; checked by the caller), step 1's energy
    within rtol 2e-5 (computed before its pcg), later energies within
    rtol 1e-3 (a few rows of the next sampling may flip their Metropolis
    decision on params that differ at rounding), the params bitwise across
    ranks (checked by the caller) and each step's update against the
    1-rank run's: dp_2 - dp_1 within a quarter of max |dp_1|, the cosine
    of dp_2 and dp_1 at least 0.99 and |dp_2| / |dp_1| within 10% of 1
    (two solves of systems that differ at rounding give nearly the same
    step; a rank that skipped or scaled its update fails all three)."""
    import torch

    steps, mine = want["steps"], got[0]["steps"]
    prev_w, prev_g, out = want["params0"], got[0]["params0"], []
    for i, (w, g) in enumerate(zip(steps, mine)):
        dw, dg = (torch.cat([(q["params"][k] - p[k]).double().ravel()
                             for k in sorted(p)])
                  for q, p in ((w, prev_w), (g, prev_g)))
        prev_w, prev_g = w["params"], g["params"]
        size = float(dw.abs().max())
        frac = float((dg - dw).abs().max()) / size
        cos = float(dg @ dw / (dg.norm() * dw.norm()))
        ratio = float(dg.norm() / dw.norm())
        d = max(float((g["params"][k] - v).abs().max())
                for k, v in w["params"].items())
        e_rel = abs(g["energy_re"] - w["energy_re"]) / abs(w["energy_re"])
        check(e_rel <= (2e-5 if i == 0 else 1e-3),
              f"sharded {name} step {i + 1}: energies differ by {e_rel} "
              "relative")
        check(frac <= 0.25 and cos >= 0.99 and abs(ratio - 1) <= 0.1,
              f"sharded {name} step {i + 1}: the update differs from the "
              f"1-rank run's by {frac:.3f} of its largest entry {size:.3e}, "
              f"cosine {cos:.6f}, norm ratio {ratio:.4f}")
        out.append({"params_max_abs_diff": d, "update_max_abs": size,
                    "update_diff_frac": frac, "update_cosine": cos,
                    "update_norm_ratio": ratio, "energy_rel_diff": e_rel})
    return {"steps": out}


def sharded_legs(group, n_ranks: int) -> dict:
    """Every sharded leg on this rank of ``n_ranks`` (or on all walkers with
    no group), and this rank's heis10x10_sr step split
    (``utils/profiling.step_split``, collectives included)."""
    from qmcnn_tpu_torch.utils.profiling import step_split as split

    out = {}
    for name, cfg in sharded_configs(n_ranks).items():
        if group is None and name.startswith("gcnn_ring"):
            continue  # one rank takes no assembly: gcnn_gather serves both
        out[name], vmc, state = shard_leg(cfg, group)
        if name == "heis10x10_sr":
            out["heis_split"] = split(vmc, state, 3)
    return out


def sharded_rank_main(argv) -> int:
    """One spawned rank: ``chip_smoke.py --sharded-rank R --world W --port
    P --out DIR --backend B`` joins a group at tcp://localhost:P (gloo: on
    cuda:0; nccl: on cuda:R, one rank per card), runs :func:`sharded_legs`
    and saves them to DIR/rank<R>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from qmcnn_tpu_torch.parallel.mesh import walker_group

    rank, world, port, out, backend = (int(argv[1]), int(argv[3]),
                                       int(argv[5]), Path(argv[7]), argv[9])
    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    group = walker_group(device=device)
    recs = sharded_legs(group, world)
    torch.save(recs, out / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def sharded_cards_main(n_cards: int) -> int:
    """``python3 chip_smoke.py --sharded-cards N`` (N cards): only the
    sharded phase, its N ranks over NCCL one per card, against 1 rank on
    cuda:0 — what one card cannot show (NCCL between cards, the step time
    per rank without two ranks sharing a card)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n_cards:
        print(f"chip_smoke: --sharded-cards {n_cards} needs {n_cards} CUDA "
              "devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    card = card_line()
    print(f"[1] device: {card}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda mod: mod.build(), (k1, k2)))
    out_dir = ROOT / ".runs" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sharded_phase(out_dir, card, n_cards, "nccl")
    print(f"    sharded phase {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


# ---------------------------------------------------------------------------
# the tooling (scan, supervise, the checked step, profiling, MFU, the ViT's
# bf16 trunk, native ED)
# ---------------------------------------------------------------------------

#: where the tooling legs write what a caller reads back (git-ignored)
TOOLING_OUT = ROOT / "chiprun_out" / "tooling"
#: the supervised leg's overrides of configs/heis10x10_sr.yaml
SUPERVISE_OVERRIDES = (f"run.init_from={FIXTURE}", "run.n_steps=6",
                       "run.steps_per_dispatch=1", "run.ckpt_every=2",
                       "run.log_every=1")
#: the scan leg: tfim16_sgd at full width over three fields
SCAN_VALUES = (3.0, 2.0, 1.5)
SCAN_STEPS = 100


def child_pids(pid: int) -> list:
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        # pid (comm) state ppid ...: comm may hold spaces, so split after ")"
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry.name))
    return out


def tooling_scan_leg(out_dir: Path, card: str) -> dict:
    """(a) ``python -m qmcnn_tpu_torch.scan`` over tfim16_sgd at full width
    (N = 16, C = [12, 12], k = 5, M = 2,048), h = 3.0, 2.0, 1.5, 100 steps a
    point, as a subprocess whose wrapper prints K1's launches at its end:
    every point an ED energy and rel_err < 0.15, point 0 cold and points 1
    and 2 warm, each point's npz loading through ``params_from_jax`` with
    the model's keys and shapes, K1 launches exactly 3 x the run's
    ``expected_launches``."""
    import numpy as np
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    scan_dir = out_dir / "scan"
    shutil.rmtree(scan_dir, ignore_errors=True)
    argv = ["--config", str(TFIM16_CONFIG), "--param", "hamiltonian.h",
            "--values", ",".join(str(v) for v in SCAN_VALUES),
            "--steps-per-point", str(SCAN_STEPS), "--out", str(scan_dir)]
    code = ("import json, runpy, sys\n"
            f"sys.argv = ['scan'] + {argv!r}\n"
            "try:\n"
            "    runpy.run_module('qmcnn_tpu_torch.scan', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "from qmcnn_tpu_torch.kernels import gcnn_forward as k2\n"
            "from qmcnn_tpu_torch.kernels import metropolis_sweep as k1\n"
            "print(json.dumps({'scan_launches': {"
            "'k1': k1.metropolis_sweep.launches, "
            "'k2_f32': k2.gcnn_group_sums.launches, "
            "'k2_bf16': k2.gcnn_group_sums.launches_bf16}}))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    (out_dir / "scan.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"(a) scan: rc {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    got = json.loads(lines[-1])["scan_launches"]
    rows = json.loads((scan_dir / "summary.json").read_text())["rows"]
    cfg = configs.load(str(TFIM16_CONFIG), (f"run.n_steps={SCAN_STEPS}",))
    vmc, params, _ = build(cfg, device="cuda")
    want = len(SCAN_VALUES) * expected_launches(cfg, vmc)["run"]
    print(f"    (a) python -m qmcnn_tpu_torch.scan, tfim16_sgd h = "
          f"{list(SCAN_VALUES)}, {SCAN_STEPS} steps a point: {wall:.1f} s in "
          f"all, launches {got} (K1 expected {want}); per point "
          + "; ".join(f"h={r['value']:g} E {r['energy']:.5f} +- "
                      f"{r['stderr']:.5f}, ED {r['e_exact']:.6f}, rel_err "
                      f"{r['rel_err']:.4e}, {r['seconds']:.1f} s"
                      for r in rows) + f" ({card})")
    check(got["k1"] == want and got["k2_f32"] == got["k2_bf16"] == 0,
          f"(a) scan: launches {got}, K1 expected {want}")
    check([r["value"] for r in rows] == list(SCAN_VALUES),
          f"(a) scan: rows {rows}")
    for r in rows:
        check(r["e_exact"] is not None and np.isfinite(r["energy"])
              and r["rel_err"] < 0.15,
              f"(a) scan: h={r['value']}: rel_err {r['rel_err']}")
    starts = [ln for ln in lines if ln.startswith("scan [")
              and "E =" not in ln]
    check(len(starts) == 3 and "(cold start)" in starts[0]
          and all("(warm from point_" in ln for ln in starts[1:]),
          f"(a) scan: start lines {starts}")
    for i, v in enumerate(SCAN_VALUES):
        point = params_from_jax(load_checkpoint_params(
            str(scan_dir / f"point_{i}_{v:g}.npz")), "cuda")
        check(sorted(point) == sorted(params) and all(
            point[k].shape == params[k].shape for k in params),
            f"(a) scan: point {i}'s npz does not hold the model's params")
    return {"launches": got, "expected_k1": want, "seconds": wall,
            "rel_err": [r["rel_err"] for r in rows]}


def start_supervised(out_dir: Path) -> dict:
    """(b) part 1: ``python -m qmcnn_tpu_torch.supervise`` on heis10x10_sr
    from the fixture (6 steps, a chunk a step, a checkpoint every 2, the
    checkpoints under ``TOOLING_OUT``), and a watcher thread that SIGSTOPs the
    child's process group once its .events holds ``save_end 2`` (a wedged
    dispatch: no exception, no output). The child settles 2 s after each
    save (``run.save_settle_s``), so the watcher's 0.2 s poll stops it
    before step 3 however fast a step runs."""
    import signal
    import threading

    sup_dir = TOOLING_OUT
    ckpt = sup_dir / "heis10x10_sr_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    csv = sup_dir / "heis10x10_sr_supervised.csv"
    for suffix in ("", ".params.npz", ".meta.json"):
        Path(str(csv) + suffix).unlink(missing_ok=True)
    argv = [sys.executable, "-m", "qmcnn_tpu_torch.supervise", "--config",
            str(ROOT / "configs" / "heis10x10_sr.yaml"), "--stall-timeout",
            "20", "--poll", "1"]
    for ov in SUPERVISE_OVERRIDES + (f"run.ckpt_dir={ckpt}",
                                     f"run.csv_path={csv}",
                                     "run.save_settle_s=2.0"):
        argv += ["--override", ov]
    log = open(sup_dir / "supervise.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    events = ckpt / "heartbeat.events"
    state = {"stopped": None}

    def watch():
        deadline = time.monotonic() + 300
        while proc.poll() is None and time.monotonic() < deadline:
            if events.exists() and any(
                    line.split()[1:3] == ["save_end", "2"]
                    for line in events.read_text().splitlines()):
                kids = child_pids(proc.pid)
                if kids:
                    os.killpg(kids[0], signal.SIGSTOP)
                    state["stopped"] = (kids[0], time.perf_counter() - t0)
                return
            time.sleep(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return {"proc": proc, "watcher": watcher, "state": state, "t0": t0,
            "log": log, "dir": sup_dir, "ckpt": ckpt, "csv": csv}


def finish_supervised(run: dict, twin_params, card: str) -> dict:
    """(b) part 2: the supervisor killed the stopped child and started
    attempt 2, which printed ``resumed from checkpoint at step 2`` and
    ended with rc 0; the final .params.npz is bitwise the uninterrupted
    in-process run's (``twin_params``); .events holds the five event names
    and the last heartbeat reads step 6."""
    import numpy as np
    from qmcnn_tpu_torch.supervise import read_heartbeat
    from qmcnn_tpu_torch.utils.transfer import params_to_jax

    import signal

    proc = run["proc"]
    try:
        rc = proc.wait(timeout=400)
    finally:
        if proc.poll() is None:  # its SIGTERM handler kills the child
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        stopped = run["state"]["stopped"]
        for pgid in ([stopped[0]] if stopped else []) + child_pids(proc.pid):
            try:
                os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        run["log"].close()
    run["watcher"].join(timeout=10)
    wall = time.perf_counter() - run["t0"]
    text = (run["dir"] / "supervise.log").read_text()
    hb = read_heartbeat(str(run["ckpt"] / "heartbeat"))
    names = {line.split()[1] for line in
             (run["ckpt"] / "heartbeat.events").read_text().splitlines()}
    stopped = run["state"]["stopped"]
    want = params_to_jax(twin_params)
    with np.load(str(run["csv"]) + ".params.npz") as z:
        got = {k: z[k] for k in z.files}
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    bitwise = sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
    print(f"    (b) python -m qmcnn_tpu_torch.supervise, heis10x10_sr 6 "
          f"steps: rc {rc}, {wall:.1f} s in all; child SIGSTOPped "
          f"{'at ' + format(stopped[1], '.1f') + ' s' if stopped else 'never'}"
          f"; attempts {text.count('supervise: starting attempt')}, "
          f"resumed {'resumed from checkpoint at step 2' in text}, last "
          f"heartbeat {hb}, events {sorted(names)}; final params vs the "
          f"uninterrupted in-process run: bitwise {bitwise}, max |diff| "
          f"{diff:.3e} ({card})")
    check(stopped is not None, "(b) supervise: no child to stop")
    check(rc == 0, f"(b) supervise: rc {rc}")
    check("heartbeat stale" in text and "starting attempt 2" in text,
          "(b) supervise: the wedged child was not killed and restarted")
    check("resumed from checkpoint at step 2" in text,
          "(b) supervise: attempt 2 did not resume at step 2")
    check(names >= {"dispatch_start", "dispatch_end", "save_start",
                    "save_end", "save_ping"}, f"(b) events {names}")
    check(hb is not None and hb[0] == 6, f"(b) last heartbeat {hb}")
    check(bitwise, f"(b) supervised params differ from the uninterrupted "
          f"run's by {diff}")
    return {"seconds": wall, "bitwise": bitwise, "max_abs_diff": diff}


def supervise_twin(card: str):
    """(b) part 3: the same 6 steps uninterrupted in this process: the
    reference of the supervised run, and its K1 launches."""
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build

    cfg = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"),
                       SUPERVISE_OVERRIDES + ("run.csv_path=null",))
    want = expected_launches(cfg, build(cfg, device="cuda")[0])["run"]
    reset_counts()
    t0 = time.perf_counter()
    state, _, _ = train_quiet(cfg)
    got = counts()
    print(f"    (b) the uninterrupted twin in-process: "
          f"{time.perf_counter() - t0:.1f} s, launches {got} (K1 expected "
          f"{want}) ({card})")
    check(got["k1"] == want, f"(b) twin: K1 {got['k1']}, expected {want}")
    return state, got


def timed_step(run_steps, state, ids, reps: int = 3) -> float:
    """Mean ms of one ``run_steps(state, 0, ids, 1)`` over ``reps`` calls
    from the same state, after one warm-up (host clock, synchronized)."""
    import torch

    run_steps(state, 0, ids, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, m = run_steps(state, 0, ids, 1)
        float(m[0].energy_re)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def checked_pair(label: str, overrides: tuple, route: str) -> dict:
    """train() of ``overrides`` with and without run.checkify on the card:
    no fault, energies and params bitwise equal, the kernel's launches
    equal and as expected; then one step's time each way."""
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.utils.debug import checked

    out = {}
    for flag in ("false", "true"):
        cfg = configs.load(str(overrides[0]), overrides[1:] + (
            "run.log_every=1", "run.csv_path=null",
            f"run.checkify={flag}"))
        reset_counts()
        state, logger, _ = train_quiet(cfg)
        out[flag] = (state, logger.history["energy_re"], counts())
    vmc, _, _ = build(cfg, device="cuda")
    want = expected_launches(cfg, vmc)["run"]
    (s0, e0, n0), (s1, e1, n1) = out["false"], out["true"]
    same = e0 == e1 and all(torch.equal(s0.params[k], s1.params[k])
                            for k in s0.params)
    ids = torch.arange(cfg.sampler.n_walkers, device="cuda")
    plain_ms = timed_step(vmc.run_steps, s0, ids)
    checked_ms = timed_step(checked(vmc.run_steps), s0, ids)
    print(f"    (c) {label}: checked energies {e1}, bitwise {same}; launches "
          f"unchecked {n0}, checked {n1} ({route} expected {want}); one step "
          f"{plain_ms:.1f} ms unchecked, {checked_ms:.1f} ms checked")
    check(same, f"(c) {label}: the checked run differs")
    check(n0 == n1 and n1[route] == want,
          f"(c) {label}: launches {n0} / {n1}, expected {want}")
    return {"launches": n1, "bitwise": same, "ms": plain_ms,
            "checked_ms": checked_ms, "cfg": cfg, "state": s0}


def tooling_checked_leg(card: str) -> dict:
    """(c) the checked step: heis10x10_sr (2 steps from the fixture) on K1
    and j1j2_8x8_gcnn (1 step) on K2 f32, each bitwise the unchecked run;
    a NaN written into K1's packed weights outside the checked call makes
    the checked K1 call raise naming the kernel; an out-of-bounds
    index_select on the card raises the Python error before its launch,
    and K1 runs right after it (the context survived)."""
    import torch
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.utils.debug import CheckError, checked

    heis = checked_pair("heis10x10_sr, 2 steps, K1", (
        ROOT / "configs" / "heis10x10_sr.yaml", f"run.init_from={FIXTURE}",
        "sampler.n_therm_sweeps=20", "run.n_steps=2"), "k1")
    gcnn = checked_pair("j1j2_8x8_gcnn, 1 step, K2 f32", (
        GCNN_CONFIG, "sampler.n_therm_sweeps=20", "run.n_steps=1"),
        "k2_f32")
    state = heis["state"]
    params, s = state.params, state.walkers.s
    fused = k1.FusedCNNLogPsi(lattice_shape=(10, 10))
    reset_counts()
    want = fused(params, s).re.clone()
    blob = k1.packed_weights(k1.conv_layers(params, (10, 10)), 9)
    saved = blob.clone()
    blob[0] = float("nan")
    try:
        checked(fused)(params, s)
        raised = ""
    except CheckError as e:
        raised = str(e)
    finally:
        blob.copy_(saved)
    check("metropolis_sweep" in raised, f"(c) a NaN in K1's packed weights: "
          f"raised {raised!r}")
    x = torch.arange(4.0, device="cuda")
    try:
        checked(lambda t, i: torch.index_select(t, 0, i))(
            x, torch.tensor([1, 5], device="cuda"))
        oob = ""
    except CheckError as e:
        oob = str(e)
    after = fused(params, s).re
    torch.cuda.synchronize()
    print(f"    (c) a NaN in K1's packed weights: {raised!r}; index_select "
          f"[1, 5] of 4 on the card: {oob!r}; K1 after it bitwise "
          f"{torch.equal(after, want)} ({card})")
    check("out-of-bounds" in oob and "index_select" in oob,
          f"(c) out-of-bounds index_select: {oob!r}")
    check(torch.equal(after, want), "(c) K1 after the out-of-bounds check")
    k1_extra = counts()["k1"]
    return {"launches": {"k1": heis["launches"]["k1"] + k1_extra,
                         "k2_f32": gcnn["launches"]["k2_f32"]},
            "heis_ms": [heis["ms"], heis["checked_ms"]],
            "gcnn_ms": [gcnn["ms"], gcnn["checked_ms"]]}


def tooling_profile_leg(card: str) -> dict:
    """(d) a torch.profiler trace of 2 heis10x10_sr steps after one
    warm-up step: the ten CUDA kernels with the most device time, the
    device idle share of the window and its parts by the program span open
    on the host (``profiling.idle_by_span``), which sum to it; K1's kernel
    in the trace with the count the launch counters give. The gzipped
    chrome trace goes under ``TOOLING_OUT``/profile/."""
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.sampler.metropolis import fold_in, prng_key
    from qmcnn_tpu_torch.train import chunked_thermalize
    from qmcnn_tpu_torch.utils import profiling
    from qmcnn_tpu_torch.utils.transfer import warm_start

    cfg = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"))
    vmc, params, _ = build(cfg, device="cuda")
    params = warm_start(params, str(FIXTURE))
    m = cfg.sampler.n_walkers
    ids = torch.arange(m, device="cuda")
    state = vmc.init_state(prng_key(1), m, params, device="cuda")
    state = chunked_thermalize(vmc, state, prng_key(2), ids, 20, 0)
    state, _ = vmc.step(state, fold_in(prng_key(3), 0), ids)  # warm-up
    torch.cuda.synchronize()
    logdir = TOOLING_OUT / "profile"
    with profiling.trace(str(logdir / "warmup")):  # the profiler's start-up
        torch.ones(1, device="cuda").add_(1.0)
    reset_counts()
    profiling.clear()
    t0 = time.perf_counter()
    with profiling.trace(str(logdir)) as prof:
        for i in (1, 2):
            state, _ = vmc.step(state, fold_in(prng_key(3), i), ids)
    window = time.perf_counter() - t0
    n = counts()
    table = profiling.kernel_table(prof)
    idle = profiling.idle_share(prof)
    parts, untraced = profiling.idle_by_span(prof, profiling.spans())
    profiling.clear()
    layers = defaultdict(float)
    for name, share in parts.items():
        layers[name.split(".")[0]] += share
    events = list(prof.events())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    sweep = [r for r in table if "sweep_kernel" in r["name"]]
    device_ms = sum(r["total_ms"] for r in table)
    size = (logdir / profiling.TRACE_FILE).stat().st_size
    print(f"    (d) torch.profiler, 2 heis10x10_sr steps ({card}): traced "
          f"window {span:.1f} ms ({window * 1e3:.1f} ms of host clock with "
          f"the export), device time {device_ms:.2f} ms in {len(table)} "
          f"kernel names, device idle share "
          f"{idle if idle is None else round(idle, 4)} (the profiler on); "
          f"trace {size} bytes; launches {n}; the ten largest:")
    for r in table[:10]:
        print(f"      {r['total_ms']:9.3f} ms  x{r['count']:<5d} "
              f"{r['name'][:110]}")
    print("    (d) the idle share by the span open on the host: "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(layers.items(), key=lambda kv: -kv[1]))
          + f", untraced {untraced:.4f}; inside sr: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items())
                      if k.startswith("sr")))
    check(table, "(d) key_averages() shows no device time")
    check(idle is not None and 0.0 <= idle < 1.0, f"(d) idle share {idle}")
    check(abs(sum(parts.values()) + untraced - idle) < 1e-4
          and layers["sr"] > 0.0,
          f"(d) idle by span {dict(layers)} + {untraced} against {idle}")
    check(len(sweep) == 1 and sweep[0]["count"] == n["k1"] == 6,
          f"(d) K1 in the trace {sweep}, counted {n}")
    return {"launches": n, "idle_share": idle, "device_ms": device_ms,
            "idle_by_span": dict(layers, untraced=untraced),
            "window_ms": span,
            "top": [{k: r[k] for k in ("name", "count", "total_ms")}
                    for r in table[:10]],
            "state": state, "vmc": vmc, "ids": ids}


def tooling_mfu_leg(card: str, prof: dict) -> dict:
    """(e) MFU of K1's flagship sweep (hand FLOPs / CUDA-event time), of K2
    f32 at the j1j2_8x8_gcnn E_loc chunk, and of one whole heis10x10_sr
    step (``step_flops`` / host-clock step time), each with its peak."""
    import torch
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels.metropolis_sweep import metropolis_sweep
    from qmcnn_tpu_torch.lattice import square
    from qmcnn_tpu_torch.sampler.metropolis import sweep_noise
    from qmcnn_tpu_torch.utils.mfu import (H100_FP32_CORE_FLOPS,
                                           device_peak_flops, fmt_mfu,
                                           forward_flop, gcnn_flop, mfu,
                                           pallas_sweep_flops_per_proposal,
                                           step_flops)
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    peak = device_peak_flops("float32")
    check(peak is not None, f"(e) no float32 peak for {card}")
    reset_counts()
    flagship = params_from_jax(load_checkpoint_params(str(FIXTURE)), "cuda")
    case = sweep_case("heis10x10", flagship, square(10), 2048, "exchange", 1,
                      "cuda")
    m, n = case["s"].shape
    noise = sweep_noise(case["key"], case["ids"], n, case["n_choices"])
    sweep_ms = cuda_ms(lambda: metropolis_sweep(
        flagship, case["s"], case["lp"], lattice_shape=(10, 10), n_props=n,
        move="exchange", bonds=case["bonds"], noise=noise), reps=10)
    sweep_flop = m * n * forward_flop(flagship, n)
    tpu_model = m * n * pallas_sweep_flops_per_proposal(flagship, (10, 10))
    main_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                   complex_params=True, param_scale=0.05)
    _, ws, x, kw = gcnn_case(main_kw, 256 * 256 * 2, 26, "cuda")
    k2_ms = cuda_ms(lambda: k2.gcnn_group_sums(x, ws, **kw), reps=5)
    k2_flop = gcnn_flop(64, 64, 3, True, x.shape[0])
    launches = counts()
    vmc, state, ids = prof["vmc"], prof["state"], prof["ids"]
    step_fl = step_flops(vmc, state, ids)
    step_ms = timed_step(vmc.run_steps, state, ids)
    rows = {
        "k1_sweep": (sweep_flop, sweep_ms),
        "k2_f32_e_loc_chunk": (k2_flop, k2_ms),
        "heis10x10_sr_step": (step_fl, step_ms),
    }
    out = {}
    for name, (flop, ms) in rows.items():
        frac = mfu(flop, ms / 1e3, "float32")
        out[name] = {"flop": flop, "ms": ms, "mfu": frac}
        print(f"    (e) MFU {name}: {flop:.4e} FLOP in {ms:.4f} ms = "
              f"{flop / ms / 1e9:.2f} TFLOP/s, {fmt_mfu(frac)} of the "
              f"float32 peak {peak:.4g} (3xTF32; the FP32-core rate "
              f"{H100_FP32_CORE_FLOPS:.3g}: "
              f"{100 * flop / (ms / 1e3) / H100_FP32_CORE_FLOPS:.1f}%) "
              f"({card})")
        check(frac is not None and 0.0 < frac < 1.0, f"(e) {name}: {frac}")
    ratio = tpu_model / sweep_flop
    print(f"    (e) the TPU kernel's dense-circulant model counts "
          f"{tpu_model:.4e} FLOP for the same sweep ({ratio:.1f}x K1's "
          f"work; not K1's numerator); launches {launches}")
    out["launches"] = launches
    return out


def vit8_bf16_leg(out_dir: Path, card: str, vit8=None) -> dict:
    """(f) the j1j2_8x8_vit_cap snapshot with the bf16 trunk: E_loc on one
    set of thermalized walkers at the snapshot's params in f32 and in bf16
    (the mean difference under 3 binned stderr of the f32 mean), then 4
    bf16 steps from those walkers (finite energies, |E_im| under 3 binned
    stderr, K1 = K2 = 0) and the bf16 step split. ``vit8``: (config, state)
    of the families phase's f32 leg, whose walkers are used; None: 20
    thermalization sweeps at the snapshot's params here."""
    import numpy as np
    import torch
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.ops.local_energy import local_energy
    from qmcnn_tpu_torch.sampler.metropolis import prng_key
    from qmcnn_tpu_torch.train import chunked_thermalize
    from qmcnn_tpu_torch.utils.metrics import binned_stderr
    from qmcnn_tpu_torch.utils.transfer import warm_start

    t0 = time.perf_counter()
    if vit8 is None:
        cfg = meta_config(VIT8_META, ("sampler.n_therm_sweeps=20",))
        vmc, params, _ = build(cfg, device="cuda")
        params = warm_start(params, str(VIT8_FIXTURE))
        m = cfg.sampler.n_walkers
        ids = torch.arange(m, device="cuda")
        state = vmc.init_state(prng_key(5), m, params, device="cuda")
        state = chunked_thermalize(vmc, state, prng_key(6), ids, 20, 10)
    else:
        cfg, state = vit8
    cfg16 = configs.apply_overrides(cfg, ("model.compute_dtype=bfloat16",))
    vmc16, _, _ = build(cfg16, device="cuda")
    vmc32, _, _ = build(cfg, device="cuda")
    w, params = state.walkers, state.params
    e = {}
    with torch.no_grad():
        for dtype, vmc in (("float32", vmc32), ("bfloat16", vmc16)):
            lp = vmc.eval_log_psi_fn(params, w.s)
            e[dtype] = local_energy(vmc.eval_log_psi_fn, params, vmc.ham,
                                    w.s, lp, chunk_size=vmc.chunk_size
                                    ).re.double()
    diff = float((e["bfloat16"] - e["float32"]).mean())
    err = binned_stderr(e["float32"].cpu().numpy())
    print(f"    (f) j1j2_8x8_vit_cap E_loc on {w.s.shape[0]} walkers: f32 "
          f"{float(e['float32'].mean()) / 64:.6f}/site, bf16 "
          f"{float(e['bfloat16'].mean()) / 64:.6f}/site; mean difference "
          f"{diff:.5f} vs binned stderr of the f32 mean {err:.5f} "
          f"({abs(diff) / err:.2f} stderr)")
    check(np.isfinite(diff) and abs(diff) < 3 * err,
          f"(f) ViT bf16 E_loc mean differs by {diff}, >= 3 x {err}")
    ids = torch.arange(cfg.sampler.n_walkers, device="cuda")
    state16 = vmc16.init_state(prng_key(0), cfg.sampler.n_walkers, params,
                               device="cuda")._replace(walkers=w)
    reset_counts()
    new, metrics = vmc16.run_steps(state16, prng_key(9), ids, 4)
    n = counts()
    energies = [float(mt.energy_re) / 64 for mt in metrics]
    print(f"    (f) 4 bf16 steps: E/site {[round(v, 5) for v in energies]}, "
          f"E_im {[round(float(mt.energy_im), 5) for mt in metrics]}, "
          f"launches {n}")
    check(np.isfinite(energies).all(), "(f) non-finite bf16 energies")
    check(sum(n.values()) == 0, f"(f) the ViT launched a kernel {n}")
    e_im_check("(f) j1j2_8x8_vit_cap bf16", vmc16, new)
    split = step_split(cfg16, new, card, "j1j2_8x8_vit_cap bf16", vmc=vmc16,
                       n_steps=1)
    if vit8 is None:  # else phase 5 prints the f32 split of this call
        step_split(cfg, state, card, "j1j2_8x8_vit_cap f32", vmc=vmc32,
                   n_steps=1)
    return {"seconds": time.perf_counter() - t0, "e_loc_diff": diff,
            "stderr": err, "split": split}


def native_ed_leg(card: str) -> dict:
    """(g) the native ED library built here (g++), its tfim16 and 4x4
    Heisenberg ground energies against the port's sparse ops/exact.py
    (1e-9 relative), and the 24-site Heisenberg chain in its S^z = 0 sector
    (C(24, 12) = 2,704,156 states) against the Bethe ansatz (1e-8)."""
    from qmcnn_tpu_torch.lattice import chain, square
    from qmcnn_tpu_torch.ops import bethe, exact, exact_native

    t0 = time.perf_counter()
    check(exact_native.available(), f"(g) native ED: "
          f"{exact_native._load_error}")
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s}
    c16, sq = chain(16), square(4)
    for name, op, sp in (
            ("tfim16", exact_native.tfim_operator(16, c16.nn_bonds),
             exact.sparse_tfim(16, c16.nn_bonds)),
            ("heis4x4", exact_native.heisenberg_operator(16, sq.nn_bonds),
             exact.sparse_heisenberg(16, sq.nn_bonds))):
        t0 = time.perf_counter()
        got = exact_native.ground_energy(op)
        solve = time.perf_counter() - t0
        want = exact.ground_energy(sp)
        rel = abs(got - want) / abs(want)
        print(f"    (g) {name}: native {got:.12f} in {solve:.2f} s, sparse "
              f"{want:.12f}, relative {rel:.2e}")
        check(rel < 1e-9, f"(g) {name}: {got} vs {want}")
        out[name] = {"e": got, "solve_s": solve, "rel": rel}
    t0 = time.perf_counter()
    op = exact_native.heisenberg_sector_operator(24, chain(24).nn_bonds)
    got = exact_native.ground_energy(op)
    solve = time.perf_counter() - t0
    want = bethe.ground_energy(24)
    rel = abs(got - want) / abs(want)
    print(f"    (g) heis24 chain, S^z = 0 ({op.shape[0]} states): native "
          f"{got:.12f} in {solve:.2f} s, Bethe {want:.12f}, relative "
          f"{rel:.2e}; build {build_s:.2f} s "
          f"({exact_native._lib.ed_num_threads()} threads; {card})")
    check(op.shape[0] == 2704156 and rel < 1e-8,
          f"(g) heis24: {got} vs {want}")
    out["heis24"] = {"e": got, "solve_s": solve, "rel": rel}
    return out


def tooling_phase(out_dir: Path, card: str, vit8=None) -> dict:
    """The tooling (``scan``, ``supervise``, ``utils/debug``,
    ``utils/profiling``, ``utils/mfu``, the ViT's bf16 trunk,
    ``ops/exact_native``): the supervised run (b) goes first, and while it
    runs the legs that time nothing on the card: its uninterrupted twin,
    (a) the scan subprocess and (g) native ED; then, alone on the card,
    (c) the checked steps, (d) the profile, (e) MFU and (f) the ViT in
    bf16. Each leg's counters are zeroed just before it and read just after
    it (the scan's in its own process)."""
    t0 = time.perf_counter()
    run = start_supervised(out_dir)
    try:
        twin, twin_n = supervise_twin(card)
        scan = tooling_scan_leg(out_dir, card)
        native = native_ed_leg(card)
    finally:
        sup = finish_supervised(run, twin.params, card)
    print(f"    (a), (b), (g) {time.perf_counter() - t0:.1f} s")
    checked_leg = tooling_checked_leg(card)
    prof = tooling_profile_leg(card)
    mfu = tooling_mfu_leg(card, prof)
    vit = vit8_bf16_leg(out_dir, card, vit8)
    launches = {
        "k1": (scan["launches"]["k1"] + twin_n["k1"]
               + checked_leg["launches"]["k1"] + prof["launches"]["k1"]),
        "k2_f32": (checked_leg["launches"]["k2_f32"]
                   + mfu["launches"]["k2_f32"])}
    print(json.dumps({"tooling": {
        "launches": launches, "scan": {k: scan[k] for k in (
            "launches", "seconds", "rel_err")},
        "supervise": sup, "checked": {k: checked_leg[k] for k in (
            "launches", "heis_ms", "gcnn_ms")},
        "profile": {k: prof[k] for k in (
            "launches", "idle_share", "idle_by_span", "device_ms",
            "window_ms", "top")},
        "mfu": {k: mfu[k] for k in ("k1_sweep", "k2_f32_e_loc_chunk",
                                    "heis10x10_sr_step")},
        "vit_bf16": vit, "native": native}}, default=float))
    return launches


def phase_main(flag: str, label: str, phase) -> int:
    """``python3 chip_smoke.py --excited`` / ``--measure``: only the build
    and that phase (its legs, checks and splits), for iterating on it."""
    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke: {flag} needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1

    card = card_line()
    print(f"[1] device: {card}", flush=True)
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda mod: mod.build(), (k1, k2)))
    out_dir = ROOT / ".runs" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    phase(out_dir, card)
    print(f"    {label} phase {time.perf_counter() - t0:.1f} s")
    print(card)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_phase(out_dir: Path, card: str, n_ranks: int = SHARD_RANKS,
                  backend: str = "gloo") -> dict:
    """The sharded legs in ``n_ranks`` spawned ranks (gloo: all on cuda:0;
    nccl: one per card) against the 1-rank run on cuda:0, then the CLI
    under torchrun with NCCL. Checks: walkers bitwise equal to the 1-rank run's after
    thermalization and after step 1's sampling; energies per step within
    rtol 2e-5; params within rtol 2e-4 / atol 2e-6 (heis10x10_sr) or 5e-4
    / 5e-6 (the minSR GCNN, as the JAX hero-path test); params bitwise
    equal across ranks after every step; each rank's launches of K1
    (heis10x10_sr, the dryrun) or K2 f32 (the GCNN) as expected_launches
    gives for its walkers, and no plain evaluation forward (the complex CNN
    of the deflation leg launches nothing, as in JAX); the dryrun's energy
    finite and S^z = 0; the EMA, SPRING's carry and the overlap bitwise
    equal across ranks."""
    import numpy as np
    import torch

    work = out_dir / "sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ref = sharded_legs(None, n_ranks)
    t_ref = time.perf_counter() - t0
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
         str(r), "--world", str(n_ranks), "--port", str(port), "--out",
         str(work), "--backend", backend], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:  # stop every rank if one failed or hung
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"sharded rank {r} failed "
              f"(rc {p.returncode}):\n{log[-3000:]}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True)
             for r in range(n_ranks)]
    t_ranks = time.perf_counter() - t0 - t_ref

    report = {"ranks": n_ranks, "backend": backend,
              "devices": "cuda:0" if backend == "gloo" else "one per rank",
              "legs": {}}
    for name in sharded_configs(n_ranks):
        got = [rk[name] for rk in ranks]
        want = ref["gcnn_gather" if name == "gcnn_ring" else name]
        dry = name.startswith("dryrun")
        kernel = ("k2_f32" if name.startswith("gcnn")
                  else None if name == "defl4x4" else "k1")
        launches = [g["launches"] for g in got]
        for r, (g, n) in enumerate(zip(got, launches)):
            if kernel is None:
                check(sum(n.values()) == 0, f"sharded {name} rank {r}: "
                      f"launched {n}")
                continue
            check(n[kernel] == g["expected"] and sum(n.values()) == n[kernel],
                  f"sharded {name} rank {r}: launches {n}, expected "
                  f"{g['expected']} on {kernel}")
            check(g["fused"] in ("FusedCNNLogPsi", "FusedLogPsi"),
                  f"sharded {name}: evaluation forward {g['fused']}")
        rec = {"launches_per_rank": [sum(n.values()) if kernel is None
                                     else n[kernel] for n in launches],
               "kernel": kernel,
               "expected_per_rank": 0 if kernel is None else got[0]["expected"],
               "launches_1rank": (sum(want["launches"].values())
                                  if kernel is None
                                  else want["launches"][kernel])}
        walkers_eq = [torch.equal(torch.cat([g["s_therm"] for g in got]),
                                  want["s_therm"])]
        if not dry:
            walkers_eq.append(torch.equal(torch.cat(
                [g["steps"][0]["s"] for g in got]), want["steps"][0]["s"]))
        rec["walkers_bitwise"] = all(walkers_eq)
        check(rec["walkers_bitwise"], f"sharded {name}: walkers differ from "
              f"the 1-rank run ({walkers_eq})")
        e_rel, p_viol, p_abs = 0.0, 0.0, 0.0
        split = name == "tempering4"
        rtol, atol = ((2e-4, 2e-6) if kernel == "k1" else (5e-4, 5e-6))
        for i, w in enumerate(want["steps"]):
            gs = [g["steps"][i] for g in got]
            for g in gs[1:]:
                check(all(torch.equal(gs[0][part][k], g[part][k])
                          for part in ("params", "ema") for k in w[part])
                      and torch.equal(gs[0]["sr_aux"], g["sr_aux"])
                      and gs[0]["overlap"] == g["overlap"],
                      f"sharded {name} step {i + 1}: params, EMA, SPRING's "
                      "carry or the overlap differ across ranks")
            e_rel = max(e_rel, abs(gs[0]["energy_re"] - w["energy_re"])
                        / abs(w["energy_re"]))
            for k, v in w["params"].items():
                d = (gs[0]["params"][k] - v).abs()
                p_abs = max(p_abs, float(d.max()))
                p_viol = max(p_viol, float((d - rtol * v.abs()).max()) / atol)
            if dry:
                check(np.isfinite(gs[0]["energy_re"]),
                      f"sharded {name}: non-finite energy")
                check(all(bool((g["s"].sum(dim=1) == 0).all()) for g in gs),
                      f"sharded {name}: S^z != 0")
        rec.update(energy_max_rel_diff=e_rel, params_max_abs_diff=p_abs,
                   energies=[g["energy_re"] for g in got[0]["steps"]],
                   energies_1rank=[w["energy_re"] for w in want["steps"]],
                   sr_iters=[g["sr_iters"] for g in got[0]["steps"]],
                   sr_iters_1rank=[w["sr_iters"] for w in want["steps"]])
        if split:  # pcg's solve may move by reduction order
            rec["pcg_split"] = pcg_split_gate(name, want, got)
        elif not dry:  # the dryrun's 1 step is held to finiteness and S^z
            check(e_rel <= 2e-5, f"sharded {name}: energies differ by "
                  f"{e_rel} relative")
            check(p_viol <= 1.0, f"sharded {name}: params outside rtol "
                  f"{rtol} / atol {atol} of the 1-rank run")
        print(f"    sharded {name}: launches per rank {rec['launches_per_rank']}"
              f" (expected {rec['expected_per_rank']}; 1 rank "
              f"{rec['launches_1rank']}), walkers bitwise {rec['walkers_bitwise']},"
              f" E {rec['energies']} (1 rank {rec['energies_1rank']}), max rel "
              f"{e_rel:.2e}, params max abs diff {p_abs:.2e}, sr_iters "
              f"{rec['sr_iters']} (1 rank {rec['sr_iters_1rank']})"
              + (f", pcg split {rec['pcg_split']}" if split else ""))
        report["legs"][name] = rec
    splits = [ref["heis_split"]] + [rk["heis_split"] for rk in ranks]
    for label, sp in zip(["1 rank"] + [f"rank {r} of {n_ranks}"
                                       for r in range(n_ranks)], splits):
        print(f"    heis10x10_sr step ({card}), {label}: "
              f"{sum(sp.values()):.2f} ms = "
              + ", ".join(f"{k} {v:.2f}" for k, v in sp.items()) + " ms")
    report["heis_step_split_ms"] = {"1rank": ref["heis_split"],
                                    "ranks": [rk["heis_split"]
                                              for rk in ranks]}

    # (d) the CLI under torchrun, one rank per card shown, NCCL
    n_cards = min(torch.cuda.device_count(), 4)
    csv = out_dir / "torchrun_heis10x10_sr.csv"
    t1 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n_cards}", "-m", "qmcnn_tpu_torch.train",
         "--config", str(ROOT / "configs" / "heis10x10_sr.yaml"),
         "--override", "run.distributed=true", "--override",
         "sampler.n_therm_sweeps=4", "--override", "run.n_steps=3",
         "--override", "run.log_every=1", "--override",
         f"run.csv_path={csv}"], cwd=str(ROOT), capture_output=True,
        text=True, timeout=600)
    check(run.returncode == 0, f"torchrun ({n_cards} ranks, NCCL) failed "
          f"(rc {run.returncode}):\n{run.stdout[-2000:]}{run.stderr[-3000:]}")
    meta = json.loads(Path(str(csv) + ".meta.json").read_text())
    import csv as csvlib

    with open(csv, newline="") as f:
        rows = list(csvlib.DictReader(f))
    check(len(rows) == 3 and meta["n_devices"] == n_cards
          and all(np.isfinite(float(r["energy_re"])) for r in rows),
          f"torchrun: {len(rows)} CSV rows, n_devices {meta['n_devices']}")
    report["torchrun"] = {"nproc_per_node": n_cards, "backend": "nccl",
                          "rc": run.returncode, "steps": len(rows),
                          "final_energy_tail": meta["final_energy_tail"],
                          "seconds": time.perf_counter() - t1,
                          "train_seconds": float(rows[-1]["wall_time"])}
    print(f"    torchrun --nproc_per_node={n_cards} (NCCL): rc 0, 3 steps, "
          f"tail E/site {meta['final_energy_tail'] / 100:.5f}, "
          f"{report['torchrun']['seconds']:.1f} s in all, of which "
          f"{report['torchrun']['train_seconds']:.1f} s from the logger's "
          "start to step 3")
    report["seconds"] = {"1rank": t_ref, "ranks": t_ranks,
                         "torchrun": report["torchrun"]["seconds"]}
    print(json.dumps({"sharded": report}))
    return report


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if len(sys.argv) > 1 and sys.argv[1] == "--sharded-rank":
        return sharded_rank_main(sys.argv[1:])
    if len(sys.argv) > 1 and sys.argv[1] == "--measure-rank":
        return measure_rank_main(sys.argv[1:])
    if len(sys.argv) > 1 and sys.argv[1] == "--sharded-cards":
        return sharded_cards_main(int(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--excited":
        return phase_main("--excited", "excited", excited_phase)
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        return phase_main("--measure", "measurement", measure_phase)
    if len(sys.argv) > 1 and sys.argv[1] == "--dynamics":
        return phase_main("--dynamics", "dynamics", dynamics_phase)
    if len(sys.argv) > 1 and sys.argv[1] == "--tooling":
        return phase_main("--tooling", "tooling", tooling_phase)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "qmcnn_tpu_torch").is_dir():
        print(f"chip_smoke: qmcnn_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from qmcnn_tpu_torch import configs
    from qmcnn_tpu_torch.builder import build
    from qmcnn_tpu_torch.kernels import gcnn_forward as k2
    from qmcnn_tpu_torch.kernels import metropolis_sweep as k1
    from qmcnn_tpu_torch.lattice import chain, square
    from qmcnn_tpu_torch.sampler.metropolis import prng_key
    from qmcnn_tpu_torch.models.cnn import LogPsiCNN
    from qmcnn_tpu_torch.models.gcnn import LogPsiGCNN, SpinFlipSymmetrized
    from qmcnn_tpu_torch.train import train
    from qmcnn_tpu_torch.utils.transfer import (load_checkpoint_params,
                                                params_from_jax)

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()

    def timed_build(mod):
        t = time.perf_counter()
        path, log = mod.build()
        return path, log, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = list(pool.map(timed_build, (k1, k2)))
    print(f"[2] build: {time.perf_counter() - t0:.2f} s in all")
    ptxas = {}
    for path, log, secs in builds:
        print(f"    {path.name}: {secs:.2f} s (K2's source holds both its "
              f"float32 and bf16 routes)" if path.name.startswith("gcnn")
              else f"    {path.name}: {secs:.2f} s")
        ptxas.update(print_ptxas(log))

    # 3. kernel vs plain version on the card
    print("[3] fused sweep vs plain version (TF32 off)", flush=True)
    dev = "cuda"
    flagship = params_from_jax(load_checkpoint_params(str(FIXTURE)), dev)
    sq = square(10)
    tfim = chain(16)
    tfim_model = LogPsiCNN(tfim.shape, channels=(12, 12), kernel_size=5,
                           param_scale=0.2)
    tfim_params = tfim_model.init(11, device=dev)
    cases = {
        "flagship_exchange": sweep_case("heis10x10", flagship, sq, 2048,
                                        "exchange", 1, dev),
        "flagship_flip": sweep_case("heis10x10", flagship, sq, 2048, "flip",
                                    2, dev),
        "tfim16_flip": sweep_case("tfim16", tfim_params, tfim, 2048, "flip",
                                  3, dev),
    }
    errs = {k: compare_kernel(c)["max_abs_err"] for k, c in cases.items()}
    for k in ("flagship_flip", "tfim16_flip"):
        check_position_invariance(cases[k])

    print("[3] fused GCNN forward vs plain version (TF32 off)", flush=True)
    t0 = time.perf_counter()
    # the config's init scale: complex lncosh jumps by 2 pi k where Re
    # crosses 0 at |Im| > pi/2, and large weights put rounding-level
    # pre-activations on such branch cuts, where any two summation orders
    # may legitimately disagree
    main_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                   complex_params=True, param_scale=0.05)
    _, main_ws, main_x, main_kw2 = gcnn_case(main_kw, 2048, 21, dev)
    errs["gcnn"] = compare_gcnn("j1j2_8x8_gcnn shape (W=64, L=3, lncosh)",
                                main_ws, main_x, main_kw2, 1e-4)
    d12_params = params_from_jax(load_checkpoint_params(str(D12_FIXTURE)),
                                 dev)
    d12_kw = dict(lattice_shape=(8, 8), channels=(10,) * 12,
                  complex_params=True, activation="selu", residual=True)
    _, d12_ws, d12_x, d12_kw2 = gcnn_case(d12_kw, 512, 22, dev,
                                          params=d12_params)
    compare_gcnn("d12 fixture (W=80, L=12, selu, residual)", d12_ws, d12_x,
                 d12_kw2, 1e-3)
    _, ws, x, kw = gcnn_case(dict(main_kw, complex_params=False,
                                  activation="selu", param_scale=0.3),
                             777, 23, dev)
    compare_gcnn("real params, selu, B=777", ws, x, kw, 1e-4)
    spin_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                   complex_params=True, param_scale=0.1)
    for character, sector, batch in (("A1", 1, 2048), ("B1", -1, 1001)):
        model = SpinFlipSymmetrized(LogPsiGCNN(character=character,
                                               **spin_kw), sector)
        params, _, x, _ = gcnn_case(dict(spin_kw, character=character),
                                    batch, 24, dev, model=model)
        fused_kw = dict(lattice_shape=(8, 8), channels=(8, 8, 8),
                        kernel_size=3, complex_params=True,
                        character=character, spin_flip_sector=sector)
        compare_gcnn_log_psi(f"log psi, {character}, spin-flip {sector:+d}, "
                             f"B={batch}", model, params, x, fused_kw,
                             amplitudes=character != "A1")
    for scale, seed in ((0.15, 28), (0.3, 29)):
        lncosh_at_scale(scale, 2048, seed, dev)
    print(f"    GCNN checks {time.perf_counter() - t0:.1f} s")

    print(f"[3] K2's bf16 route vs its plain bf16 version (S_g rtol "
          f"{BF16_TOL:g} of 1 + max |S_g|)", flush=True)
    t0 = time.perf_counter()
    r2_kw = dict(lattice_shape=(8, 8), channels=(10,) * 8,
                 complex_params=True, activation="selu", residual=True,
                 param_scale=1.0, init_mode="fan_in")
    _, r2_ws, r2_x, r2_kw2 = gcnn_case(r2_kw, 2048, 41, dev)
    bf16_err = compare_gcnn_bf16("gcnn_r2 shape (W=80, L=8, selu, residual, "
                                 "fan_in)", r2_ws, r2_x, r2_kw2)
    compare_gcnn_bf16("gcnn_r2 shape, ragged batch",
                      *gcnn_case(r2_kw, 777, 42, dev)[1:], witness=True)
    bf16_d12 = compare_gcnn_bf16("d12 fixture (W=80, L=12)", d12_ws, d12_x,
                                 d12_kw2, witness=True)
    compare_gcnn_bf16("real params, lncosh (W=64, L=3)", *gcnn_case(
        dict(main_kw, complex_params=False, param_scale=0.3), 777, 43,
        dev)[1:])
    for character, sector, kw_, batch in (
            ("A1", 1, r2_kw, 1001),
            ("B1", -1, spin_kw, 1001)):
        kw_ = dict(kw_, character=character)
        model = SpinFlipSymmetrized(LogPsiGCNN(**kw_), sector)
        params, _, x, _ = gcnn_case(kw_, batch, 44, dev, model=model)
        fused_kw = {k: v for k, v in kw_.items()
                    if k not in ("param_scale", "init_mode")}
        compare_gcnn_log_psi_bf16(
            f"bf16 log psi, {character}, spin-flip {sector:+d}, W="
            f"{8 * kw_['channels'][0]}, L={len(kw_['channels'])}, B={batch}",
            params, x, dict(fused_kw, kernel_size=3,
                            spin_flip_sector=sector),
            amplitudes=character != "A1")
    print(f"    bf16 checks {time.perf_counter() - t0:.1f} s")
    print("[3] K1 and K2 at the compacted E_loc batches (the rows with an "
          "element only)", flush=True)
    compacted_e_loc_checks(flagship, sq, r2_kw, dev)

    # 4. main path, counters zeroed just before and read just after
    print("[4] main path: heis10x10_sr training", flush=True)
    out_dir = ROOT / ".runs" / "chip_smoke"  # git-ignored
    out_dir.mkdir(parents=True, exist_ok=True)
    csv = out_dir / "heis10x10_sr.csv"
    cfg = configs.load(str(ROOT / "configs" / "heis10x10_sr.yaml"), (
        f"run.init_from={FIXTURE}", "run.n_steps=5", "run.log_every=1",
        f"run.csv_path={csv}"))
    vmc, _, _ = build(cfg, device="cuda")
    check(isinstance(vmc.eval_log_psi_fn, k1.FusedCNNLogPsi)
          and vmc.sampler.backend == "cuda",
          "heis10x10_sr: the sweep kernel does not serve the sampler and "
          "E_loc")
    want = expected_launches(cfg, vmc)
    reset_counts()
    t0 = time.perf_counter()
    state, logger = train(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = k1.metropolis_sweep.launches
    hist = logger.history
    e = np.asarray(hist["energy_re"])
    acc = np.asarray(hist["accept"])
    tail, _ = logger.tail_energy()
    e_site = tail / sq.n_sites
    print(f"    heis10x10_sr: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {launches} (expected {want['run']}), E/site tail "
          f"{e_site:.5f} (fixture {E_SITE_FIXTURE}), accept {acc.tolist()}, "
          f"sr_iters {hist['sr_iters']}")
    check(np.isfinite(e).all(), "non-finite energies")
    check(((acc > 0) & (acc < 1)).all(), "accept rate outside (0, 1)")
    check(min(hist["sr_iters"]) > 0, "SR ran no iterations")
    check(launches == want["run"], f"{launches} sweep-kernel launches, "
          f"expected {want['run']}")
    check(abs(e_site - E_SITE_FIXTURE) <= 0.01,
          f"E/site {e_site} not within 0.01 of {E_SITE_FIXTURE}")
    reset_counts()
    vmc.step(state, prng_key(17), torch.arange(cfg.sampler.n_walkers,
                                               device="cuda"))
    torch.cuda.synchronize()
    per_step = k1.metropolis_sweep.launches
    print(f"    one more step: sweep-kernel launches {per_step} (expected "
          f"{want['per_step']}: refresh, sweep, E_loc chunks)")
    check(per_step == want["per_step"], f"{per_step} sweep-kernel launches "
          f"in a step, expected {want['per_step']}")

    print("[4] main path: tfim16_sgd training", flush=True)
    csv_t = out_dir / "tfim16_sgd.csv"
    cfg_t = configs.load(str(ROOT / "configs" / "tfim16_sgd.yaml"), (
        "run.n_steps=20", "run.log_every=5", f"run.csv_path={csv_t}"))
    want_t = expected_launches(cfg_t, build(cfg_t, device="cuda")[0])
    reset_counts()
    t0 = time.perf_counter()
    _, logger_t = train(cfg_t, device="cuda")
    launches_t = k1.metropolis_sweep.launches
    e_t = np.asarray(logger_t.history["energy_re"])
    rel = logger_t.history["rel_err"]
    print(f"    tfim16_sgd: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {launches_t} (expected {want_t['run']}), rel_err "
          f"{[round(r, 4) for r in rel]}")
    check(np.isfinite(e_t).all(), "tfim16: non-finite energies")
    check(launches_t == want_t["run"], f"tfim16: {launches_t} kernel "
          f"launches, expected {want_t['run']}")
    # 20 plain-SGD steps barely leave the near-uniform init (E = -h N =
    # -16, rel_err 0.216): hold the tail to the variational bound and to
    # that starting point
    tail_t, err_t = logger_t.tail_energy()
    e_exact = E_TFIM16_ED
    print(f"    tfim16_sgd tail {tail_t:.5f} +- {err_t:.5f}, ED {e_exact}")
    check(e_exact - 5 * err_t - 1e-3 <= tail_t <= -15.5,
          f"tfim16: tail energy {tail_t} outside [ED, -15.5]")
    check(rel[-1] < 0.25, f"tfim16: rel_err {rel[-1]} vs ED")

    print("[4] main path: j1j2_8x8_gcnn training", flush=True)
    gcnn = gcnn_main_path(card, out_dir)
    print("[4] fixture energy: the depth-12 snapshot", flush=True)
    d12_cfg, d12_state = d12_fixture_energy(out_dir, n_therm=60)
    print("[4] main path: j1j2_8x8_gcnn_r2 (bf16) training and resume",
          flush=True)
    r2 = gcnn_r2_main_path(out_dir)
    print("[4] fixture energy: the depth-12 snapshot in bf16, and the "
          "energy bias of K2's bf16 route", flush=True)
    d12_fixture_energy(out_dir, n_therm=60, dtype="bfloat16")
    d12_energy_bias(d12_cfg, d12_state.walkers)
    print("[4] the real CNN in bf16: heis10x10_sr", flush=True)
    cnn_bf16_leg(out_dir)
    print("[4] the complex CNN: tfim12_h2 and j1j2_8x8_complex", flush=True)
    complex_cnn_legs(out_dir)
    print("[4] frustrated lattices and SPRING: the SPRING run's config on "
          "K2 bf16, tri6x3_j1j2 vs ED, the kagome GCNN and PhaseNet "
          "snapshots, tri6x6_tgcnn", flush=True)
    t0 = time.perf_counter()
    frustrated = frustrated_phase(out_dir)
    print(f"    frustrated phase {time.perf_counter() - t0:.1f} s")
    print("[4] the last ansatz families: the ViT and kagome ARNN snapshots, "
          "exact sampling by enumeration, heis40_arnn, fresh ViTs, an RBM, "
          "an averaged CNN and an XYZ chain", flush=True)
    t0 = time.perf_counter()
    families = families_phase(out_dir)
    print(f"    families phase {time.perf_counter() - t0:.1f} s")
    print("[4] excited states, EMA, sectors, (1 + alpha H) and tempering: "
          "the 8x8 E1 deflation on K2 bf16 with checkpoint and resume, the "
          "4x4 E1 deflation, the kagome Lanczos and (pi, pi) sector "
          "snapshots, heis10x10_sr tempered; each leg's step split "
          f"({card})", flush=True)
    t0 = time.perf_counter()
    excited = excited_phase(out_dir, card)
    print(f"    excited phase {time.perf_counter() - t0:.1f} s")
    print("[4] measurement: python -m qmcnn_tpu_torch.measure with every "
          "flag on the heis10x10_sr fixture (K1), --sma on the bf16 gcnn_r2 "
          "snapshot in f32 (K2's f32 route), through the CLI the kagome "
          "PhaseNet snapshot's EMA with the chirality and its Lanczos step, "
          "and the fixture's measurement in 2 gloo ranks against 1 and "
          f"under torchrun ({card})", flush=True)
    t0 = time.perf_counter()
    measured = measure_phase(out_dir, card)
    print(f"    measurement phase {time.perf_counter() - t0:.1f} s")
    print("[4] dynamics: python -m qmcnn_tpu_torch.evolve and analyze on the "
          "chain-12 quench and its spectrum (no kernel), tfim16 imaginary "
          "time in full sum on K1, the 8x8 MC quench (no kernel), "
          f"heis10x10_sr imaginary time on K1's fused sweep ({card})",
          flush=True)
    t0 = time.perf_counter()
    dynamics = dynamics_phase(out_dir, card)
    print(f"    dynamics phase {time.perf_counter() - t0:.1f} s")
    print("[4] tooling: python -m qmcnn_tpu_torch.scan over tfim16_sgd "
          "(K1), python -m qmcnn_tpu_torch.supervise on heis10x10_sr wedged "
          "and resumed (K1), the checked heis10x10_sr (K1) and j1j2_8x8_gcnn "
          "(K2 f32) steps, a torch.profiler trace of heis10x10_sr, MFU, the "
          "8x8 ViT snapshot in bf16 and native ED "
          f"({card})", flush=True)
    t0 = time.perf_counter()
    tooling = tooling_phase(out_dir, card, vit8=families["vit8"])
    print(f"    tooling phase {time.perf_counter() - t0:.1f} s")
    print(f"[4] sharded: {SHARD_RANKS} gloo ranks on cuda:0 against 1 rank "
          "(heis10x10_sr, j1j2_8x8_gcnn gather and ring, the dryrun shape "
          "with pcg and cg, heis10x10_sr tempered, the 4x4 E1 deflation), "
          "then torchrun with NCCL", flush=True)
    t0 = time.perf_counter()
    sharded_phase(out_dir, card)
    print(f"    sharded phase {time.perf_counter() - t0:.1f} s")

    # 5. timings
    print(f"[5] timings ({card})", flush=True)
    t_flag = time_sweep(cases["flagship_exchange"], card)
    t_tfim = time_sweep(cases["tfim16_flip"], card)
    n_conn = vmc.ham.n_conn
    t_x = time_e_loc_batch(flagship, sq, 2048 * (n_conn + 1), card)
    print(f"  sweep kernel: {k1.walkers_per_block(100, 9, [1, 16, 16, 16])} "
          f"walkers x 100 sites per block, "
          f"{k1.launch_threads(100, [1, 16, 16, 16], 8)} threads, "
          f"{k1.smem_bytes(100, 9, [1, 16, 16, 16], 8)} bytes of shared "
          f"memory at the flagship")
    step_split(cfg, state, card, "heis10x10_sr")
    t_eloc = time_gcnn(*gcnn_case(main_kw, 256 * 256 * 2, 26, dev)[1:], card,
                       "K2 at the E_loc chunk shape (256 x 256 x 2)")
    t_swp = time_gcnn(*gcnn_case(main_kw, 1024 * 2, 27, dev)[1:], card,
                      "K2 at the sweep shape (1024 x 2)")
    time_gcnn(d12_ws, d12_x, d12_kw2, card, "K2 at the d12 shape")
    print(f"  K2 launches per j1j2_8x8_gcnn training step: "
          f"{gcnn['per_step']}")
    step_split(gcnn["cfg"], gcnn["state"], card, "j1j2_8x8_gcnn")
    t_r2 = time_gcnn_bf16(*gcnn_case(r2_kw, 256 * 256 * 2, 45, dev)[1:], card,
                          "K2 bf16 at the gcnn_r2 E_loc chunk shape "
                          "(256 x 256 x 2)")
    t_r2s = time_gcnn_bf16(*gcnn_case(r2_kw, 1024 * 2, 46, dev)[1:], card,
                           "K2 bf16 at the gcnn_r2 sweep shape (1024 x 2)")
    t_d12 = time_gcnn_bf16(d12_ws, d12_x, d12_kw2, card,
                           "K2 bf16 at the d12 shape")
    print(f"  K2 bf16 launches per j1j2_8x8_gcnn_r2 training step: "
          f"{r2['per_step']}")
    step_split(r2["cfg"], r2["state"], card, "j1j2_8x8_gcnn_r2")
    print(f"  K2 bf16 launches per SPRING step: "
          f"{frustrated['spring']['per_step']}")
    step_split(frustrated["spring"]["cfg"], frustrated["spring"]["state"],
               card, "j1j2_8x8_gcnn_r2 with SPRING")
    step_split(*frustrated["tgcnn"], card, "tri6x6_tgcnn", n_steps=1)
    step_split(*frustrated["kgcnn"], card, "kagome3x3_kgcnn")
    step_split(*families["vit8"], card, "j1j2_8x8_vit_cap", n_steps=1)
    direct_split(*families["karnn"], card, "kagome3x3_r3_arnn")
    direct_split(*families["heis40"], card, "heis40_arnn")

    # 6. report
    rec = {
        "name": "metropolis_sweep",
        "route": "cuda",
        "source": "qmcnn_tpu_torch/csrc/metropolis_sweep.cu",
        "replaces": "qmcnn_tpu/kernels/metropolis_pallas.py:97",
        "launches": launches,
        "measure_launches": measured["k1"],
        "dynamics_launches": dynamics["k1"],
        "tooling_launches": tooling["k1"],
        "max_abs_err": errs["flagship_exchange"],
        "ms": t_flag["ms"],
        "plain_ms": t_flag["plain_ms"],
        "bound_ms": t_flag["bound_ms"],
        "bound_by": t_flag["bound_by"],
        "fp32_bound_ms": t_flag["fp32_bound_ms"],
        "library_ms": None,
        "e_loc_ms": t_x["ms"],
        "e_loc_cudnn_ms": t_x["cudnn_ms"],
        "e_loc_bound_ms": t_x["bound_ms"],
        "e_loc_fp32_bound_ms": t_x["fp32_bound_ms"],
        "e_loc_max_rel_err": t_x["max_rel_err"],
    }
    rec2 = {
        "name": "gcnn_group_sums",
        "route": "cuda",
        "source": "qmcnn_tpu_torch/csrc/gcnn_forward.cu",
        "replaces": "qmcnn_tpu/kernels/gcnn_pallas.py:259",
        "launches": gcnn["launches"],
        "measure_launches": measured["k2_f32"],
        "dynamics_launches": dynamics["k2_f32"],
        "tooling_launches": tooling["k2_f32"],
        "max_abs_err": errs["gcnn"],
        "ms": t_eloc["ms"],
        "plain_ms": t_eloc["plain_ms"],
        "bound_ms": t_eloc["bound_ms"],
        "bound_by": t_eloc["bound_by"],
        "fp32_bound_ms": t_eloc["fp32_bound_ms"],
        "library_ms": None,
    }
    print(f"    tfim16 shape: kernel {t_tfim['ms']:.4f} ms/sweep, plain "
          f"{t_tfim['plain_ms']:.4f}, bound {t_tfim['bound_ms']:.5f}, "
          f"FP32-core bound {t_tfim['fp32_bound_ms']:.5f} ({card})")
    print(f"    K2 sweep shape: kernel {t_swp['ms']:.4f} ms, plain "
          f"{t_swp['plain_ms']:.4f}, bound {t_swp['bound_ms']:.4f}, FP32-core "
          f"bound {t_swp['fp32_bound_ms']:.4f} ({card})")
    rec3 = {
        "name": "gcnn_group_sums_bf16",
        "route": "cuda",
        "source": "qmcnn_tpu_torch/csrc/gcnn_forward.cu",
        "replaces": "qmcnn_tpu/kernels/gcnn_pallas.py:259",
        "launches": r2["launches"],
        "spring_launches": frustrated["spring"]["launches"],
        "deflation_launches": excited["defl8"]["launches"],
        "deflation_per_step": excited["defl8"]["per_step"],
        "deflation_draw": excited["defl8"]["draw"],
        "measure_launches": measured["k2_bf16"],
        "dynamics_launches": dynamics["k2_bf16"],
        "max_abs_err": bf16_err["max_abs_err"],
        "ms": t_r2["ms"],
        "plain_ms": t_r2["plain_ms"],
        "bound_ms": t_r2["bound_ms"],
        "bound_by": t_r2["bound_by"],
        "library_ms": None,
        "f32_route_ms": t_r2["f32_route_ms"],
        "sweep_ms": t_r2s["ms"],
        "sweep_plain_ms": t_r2s["plain_ms"],
        "sweep_bound_ms": t_r2s["bound_ms"],
        "sweep_f32_route_ms": t_r2s["f32_route_ms"],
        "d12_ms": t_d12["ms"],
        "d12_bound_ms": t_d12["bound_ms"],
        "d12_max_rel_err": bf16_d12["max_rel_err"],
        "d12_mean_signed_rel_err": bf16_d12["mean_signed_rel_err"],
        "registers": ptxas.get("gcnn_forward_bf16_kernel<1,1,20>", {}),
    }
    print(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rec, rec2, rec3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
