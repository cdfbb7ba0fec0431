#!/usr/bin/env python3
"""Attribute the device time of the hand kernels to their parts.

    python3 tools/irls_variants.py

Needs one CUDA card and nvcc. Each variant is the shipped
``rgbid_tpu_torch/csrc`` with one part removed by a text substitution,
built into its own library under ``build/irls_variants/`` (every variant's
nvcc processes started together). All variants are timed in one process,
in turns, with torch.profiler (``chip_smoke._device_ms``) at the main
path's layouts: ESM at L3..L0, the IC step at L0, the Student-t scale (σ)
pass at L0 and fusion at 480x640 with growth on. The removed variants
compute wrong results; only their times mean anything.

Variants of the fused IRLS kernels: without the one-thread 6x6 solve,
without the last-block tail, without the per-pixel work, without both.
Variants of the σ pass and the fusion pass: without the second launch (or,
in the one-launch design, the last-block tail and the exact step's grid
barrier), without the per-pixel arithmetic (every input loaded at the
pixel's own index and summed: loads and stores only), without the gather
(the arithmetic kept, the current planes read at the pixel's own index
instead of the four projected corners); and, in the one-launch design, the
IC exact step with every block summing every row after the barrier in
place of the last block publishing the sums. Variants of the consensus
vote's stratified kernel (timed at the vote's L2 and L1 layouts): without
the per-pixel work, without the tail; in the earlier (blocks per stratum,
K) grid design also with a grid of K = 1; in the one-pass cluster design
also without the transpose sums, as one cluster of 512 or 1024 threads a
block, as 3 clusters, as 10 clusters of 128 threads a block and as 10
clusters of 8 blocks. The script reads which
design its sources hold: run from a checkout of an earlier commit (copy
this file and ``chip_smoke.py`` into it), it times that commit's design.

    python3 tools/irls_variants.py --stratified

times the stratified kernel's variants alone.

    python3 tools/irls_variants.py --vote

times the consensus vote kernel's variants alone, at the vote's own layout
(VGA L2, K 6, ``chip_smoke.phase_consensus_vote``'s timed arguments):
without the eigensolve (each stratum's delta taken from its normalised b),
with one Jacobi sweep in place of ten, without the flow metric (every
stratum agreeing only with itself), without the vote's tail (the vote,
the medians, ``decide`` and the bookkeeping); for each it prints what
``-Xptxas=-v`` says of the vote kernel (registers, stack frame, spills),
and then the device time of ``torch.linalg.eigh`` on a (6, 6, 6) float64
batch, a yardstick for the eigensolve alone. The vote's design is read
from the sources as for the stratified kernel: PR 13's one block of 576
threads (36 a stratum, shared memory and block barriers, thread 0's tail)
or the warp design (a group of 8 lanes a stratum, registers and shuffles,
a one-warp tail). Every row gives the profiler's device time and the CUDA
events' (calls back to back).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from rgbid_tpu_torch.ops import _build  # noqa: E402

SRC = ROOT / "rgbid_tpu_torch" / "csrc"
OUT = ROOT / "build" / "irls_variants"
SOURCES = tuple(s.name for s in _build.SOURCES)

# --- the fused IRLS kernels (ESM, IC normal step) --------------------------
NO_PIXEL = [
    ("esm_normal_eq.cu",
     "    esm_pixel<C>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, acc);",
     "    acc[0] += 1.f;"),
    ("ic_normal_eq.cu",
     "    ic_normal_pixel<Geo>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, "
     "cur_xi,\n                         cur_mask, acc);",
     "    acc[0] += 1.f;"),
]


def irls(no_tail) -> dict:
    return {
        "without the solve": [
            ("irls_common.cuh",
             "    solve_update(res, res + 36, damping, res[45], T, out + kResult, "
             "out + kResult + 16);\n", "")],
        "without the last-block tail": no_tail,
        "without the per-pixel work": NO_PIXEL,
        "without both": NO_PIXEL + no_tail,
    }


# --- σ and fusion, two-launch design (each with a one-block second launch) -
TWO_LAUNCH_MARK = ("ic_normal_eq.cu", "ic_sigma_finalize<<<")
TWO_LAUNCH = irls([("irls_common.cuh", "  __shared__ bool last;\n",
                    "  if (damping > -1.f) return;\n  __shared__ bool last;\n")])
TWO_LAUNCH |= {
    "σ+fusion without the second launch": [
        ("ic_normal_eq.cu",
         "  ic_sigma_finalize<<<1, kThreads, 0, st>>>(partials, n_blocks, s2x, p.use_geometric, "
         "out);\n", ""),
        ("fusion.cu", "  sum_partials<<<1, kThreads, 0, st>>>(partials, n_blocks, n_fused);\n", ""),
    ],
    "σ+fusion without the arithmetic": [
        ("ic_normal_eq.cu",
         "  if (i < p.n) {\n    const Residuals q =",
         "  if (i < p.n && p.nu > 0.f) {\n"
         "    const int j = i % (p.h * p.w);\n"
         "    acc[0] = px[i] + py[i] + pz[i] + kf_int[i] + kf_mask[i];\n"
         "    acc[1] = cur_int[j] + cur_xi[j] + cur_mask[j];\n"
         "    acc[2] = 1.f;\n"
         "  } else if (i < p.n) {\n    const Residuals q ="),
        ("fusion.cu",
         "  if (i < n) {\n    const float kfm = kf_mask[i];",
         "  if (i < n && p.grow >= 0) {\n"
         "    fuse = kf_xi[i] + kf_var[i] + kf_mask[i] + cur_xi[i] + cur_mask[i] +\n"
         "           (p.grow ? guess[i] + gmask[i] : 0.f);\n"
         "    xi_out[i] = fuse; var_out[i] = fuse; fuse_out[i] = fuse; claim_out[i] = fuse;\n"
         "  } else if (i < n) {\n    const float kfm = kf_mask[i];"),
    ],
    "σ+fusion without the gather (IC step too)": [
        ("ic_normal_eq.cu",
         "  const irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);",
         "  irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);\n"
         "  cn.i00 = cn.i01 = cn.i10 = cn.i11 = i % (p.h * p.w);"),
        ("fusion.cu",
         "    const int i00 = v0 * p.w + u0, i01 = v0 * p.w + u1;\n"
         "    const int i10 = v1 * p.w + u0, i11 = v1 * p.w + u1;",
         "    const int i00 = i, i01 = i;\n    const int i10 = i, i11 = i;"),
    ],
}


# --- σ and fusion, one-launch design (the σ steps of IC exact mode are
# phases of the IC step's cooperative launch; fusion is one launch) ------
ONE_LAUNCH = irls([("irls_common.cuh",
                    "  if (!last_to_arrive(counter, kNormalSums)) return false;\n",
                    "  if (damping > -1.f) return false;\n"
                    "  if (!last_to_arrive(counter, kNormalSums)) return false;\n")])
ONE_LAUNCH |= {
    "σ+fusion without the tail and barrier": [
        ("ic_normal_eq.cu", "  if (!irls::last_to_arrive(counter, kSigmaSums)) return;\n",
         "  if (p.nu > 0.f) return;\n"
         "  if (!irls::last_to_arrive(counter, kSigmaSums)) return;\n"),
        ("ic_normal_eq.cu",
         "    const unsigned int seen = irls::grid_arrive(counter + 1, counter + 2, last);\n",
         "    const unsigned int seen = 0u;\n    last = false;\n"),
        ("ic_normal_eq.cu", "      irls::grid_wait(counter + 2, seen);\n", ""),
        ("fusion.cu", "  if (!irls::last_to_arrive(counter, 1)) return;\n",
         "  if (p.h > 0) return;\n  if (!irls::last_to_arrive(counter, 1)) return;\n"),
    ],
    "σ+fusion without the arithmetic": [
        ("ic_normal_eq.cu",
         "    ic_sigma_pixel(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, "
         "cur_mask,\n                   acc);\n",
         "    const int j = i % (p.h * p.w);\n"
         "    acc[0] += px[i] + py[i] + pz[i] + kf_int[i] + kf_mask[i];\n"
         "    acc[1] += cur_int[j] + cur_xi[j] + cur_mask[j];\n"
         "    acc[2] += 1.f;\n"),
        ("fusion_pixel.cuh",
         "  float xi_eff = kx, mask_eff = kfm, gs = 0.f, gm = 0.f;\n",
         "  if (p.grow >= 0) {\n"
         "    const int i = iv * p.w + iu;\n"
         "    Out o;\n"
         "    o.xi = o.var = o.mask = o.hits = o.fuse =\n"
         "        kx + kv + kfm + hits + ro(cur_xi + i) + ro(cur_mask + i);\n"
         "    return o;\n"
         "  }\n"
         "  float xi_eff = kx, mask_eff = kfm, gs = 0.f, gm = 0.f;\n"),
    ],
    "σ+fusion without the gather (IC step too)": [
        ("ic_normal_eq.cu",
         "  const irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);",
         "  irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);\n"
         "  cn.i00 = cn.i01 = cn.i10 = cn.i11 = i % (p.h * p.w);"),
        ("fusion_pixel.cuh",
         "  const int i00 = v0 * p.w + u0, i01 = v0 * p.w + u1;\n"
         "  const int i10 = v1 * p.w + u0, i11 = v1 * p.w + u1;",
         "  const int i00 = iv * p.w + iu, i01 = i00;\n  const int i10 = i00, i11 = i00;"),
    ],
    # The other way to share a step's scales: every block sums every row
    # itself after the barrier (the rows of consecutive steps would then
    # need two buffers; this variant times it with one).
    "IC exact: every block sums all rows": [
        ("ic_normal_eq.cu",
         "    if (last) {\n"
         "      irls::sum_rows<kSigmaSums>(sigma_rows, gridDim.x, sums);\n"
         "      if (threadIdx.x < kSigmaSums) published[threadIdx.x] = sums[threadIdx.x];\n"
         "      irls::grid_release(counter + 2);\n"
         "    } else {\n"
         "      irls::grid_wait(counter + 2, seen);\n"
         "      if (threadIdx.x < kSigmaSums) "
         "sums[threadIdx.x] = __ldcg(published + threadIdx.x);\n"
         "      __syncthreads();\n"
         "    }\n",
         "    if (last) irls::grid_release(counter + 2);\n"
         "    else irls::grid_wait(counter + 2, seen);\n"
         "    irls::sum_partials<kSigmaSums>(sigma_rows, gridDim.x, sums);\n"),
    ],
}


# --- the consensus vote's stratified kernel -------------------------------
# The earlier (blocks per stratum, K) grid: every block reads the mask and
# inverse depth of its share and does the per-pixel work for its own
# stratum; the last block sums K x 50 columns over the rows.
STRATIFIED_GRID_MARK = ("esm_stratified.cu", "const dim3 grid(bx, sp.k);")
STRATIFIED_GRID = {
    "stratified without the per-pixel work": [
        ("esm_stratified.cu", "    if (m == 0.f || stratum_of(xi[i], sp) != k) continue;\n",
         "    if (m == 0.f || stratum_of(xi[i], sp) != k) continue;\n"
         "    if (p.n > 0) {\n      acc[0] += m;\n      continue;\n    }\n")],
    "stratified without the tail": [
        ("esm_stratified.cu", "  if (!irls::last_to_arrive(counter, kSums)) return;\n",
         "  if (p.n > 0) return;\n  if (!irls::last_to_arrive(counter, kSums)) return;\n")],
    "stratified K = 1 grid": [
        ("esm_stratified.cu", "const dim3 grid(bx, sp.k);", "const dim3 grid(bx, 1);")],
}
# One pass over the template for all strata, the blocks of a cluster summed
# through distributed shared memory.
STRATIFIED_CLUSTER = {
    "stratified without the per-pixel work": [
        ("esm_stratified.cu", "    if (todo == 0u) continue;\n",
         "    if (todo == 0u) continue;\n"
         "    if (p.n > 0) {\n"
         "      if (lane == 0) wrow[0] += static_cast<float>(__popc(todo));\n"
         "      continue;\n"
         "    }\n")],
    "stratified without the transpose sums": [
        ("esm_stratified.cu",
         "__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {\n",
         "__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {\n"
         "  if (lane >= 0) {\n    float s = 0.f;\n"
         "    for (int j = 0; j < 32; ++j) s += v[j];\n    return s;\n  }\n")],
    "stratified without the tail": [
        ("esm_stratified.cu", "  const unsigned int rank = cluster.block_rank();\n",
         "  if (p.n > 0) return;\n  const unsigned int rank = cluster.block_rank();\n")],
    "stratified 512 threads, 3 pixels a thread (one cluster)": [
        ("esm_stratified.cu", "constexpr int kBlockThreads = 256;",
         "constexpr int kBlockThreads = 512;"),
        ("esm_stratified.cu", "constexpr int kPixelsPerThread = 1;",
         "constexpr int kPixelsPerThread = 3;")],
    "stratified 1024 threads, 2 pixels a thread (one cluster)": [
        ("esm_stratified.cu", "constexpr int kBlockThreads = 256;",
         "constexpr int kBlockThreads = 1024;"),
        ("esm_stratified.cu", "constexpr int kPixelsPerThread = 1;",
         "constexpr int kPixelsPerThread = 2;")],
    "stratified 256 threads, 2 pixels a thread (3 clusters)": [
        ("esm_stratified.cu", "constexpr int kPixelsPerThread = 1;",
         "constexpr int kPixelsPerThread = 2;")],
    "stratified 128 threads (10 clusters)": [
        ("esm_stratified.cu", "constexpr int kBlockThreads = 256;",
         "constexpr int kBlockThreads = 128;")],
    "stratified 8 blocks a cluster (10 clusters)": [
        ("esm_stratified.cu", "constexpr int kClusterBlocks = 16;",
         "constexpr int kClusterBlocks = 8;")],
}


# --- the consensus vote kernel ---------------------------------------------
# PR 13's design: one block of 576 threads, 36 per stratum for its Jacobi
# eigensolve in shared memory (three block barriers a round), one thread
# per stratum pair for the flow metric, thread 0 for the rest.
VOTE_BLOCK_MARK = ("consensus_vote.cu", "constexpr int kThreads = kMaxK * 36;")
VOTE_BLOCK = {
    "vote without the eigensolve": [
        ("consensus_vote.cu", "  strata_deltas(s, inv_n, K, delta);\n",
         "  if (t < K * 6) delta[t / 6][t % 6] = s[(t / 6) * kCols + 21 + t % 6] * inv_n[t / 6];\n"
         "  __syncthreads();\n")],
    "vote with 1 Jacobi sweep": [
        ("consensus_vote.cu", "constexpr int kSweeps = 10;", "constexpr int kSweeps = 1;")],
    "vote without the flow metric": [
        ("consensus_vote.cu", "  if (t < K * K) {\n    const int j = t / K, k = t % K;\n",
         "  if (t < K * K) agree[t / K][t % K] = t / K == t % K;\n"
         "  if (t < 0) {\n    const int j = t / K, k = t % K;\n")],
    "vote without the tail": [
        ("consensus_vote.cu", "  if (t != 0) return;\n", "  if (t != 0 || K > 0) return;\n")],
}
# The warp design: a group of 8 lanes a stratum for its eigensolve in
# registers and shuffles, one stratum pair a thread for the flow metric
# (ballots into row bitmasks), the last warp for the rest.
VOTE_WARP = {
    "vote without the eigensolve": [
        ("consensus_vote.cu", "  strata_deltas(s, K, delta, diag);\n",
         "  if (threadIdx.x < K * 6)\n"
         "    delta[threadIdx.x / 6][threadIdx.x % 6] =\n"
         "        s[(threadIdx.x / 6) * kCols + 21 + threadIdx.x % 6] /\n"
         "        clamp_min(s[(threadIdx.x / 6) * kCols + 27], 1.f);\n")],
    "vote with 1 Jacobi sweep": VOTE_BLOCK["vote with 1 Jacobi sweep"],
    "vote without the flow metric": [
        ("consensus_vote.cu", "  agreement(s, delta, K, p.tol * bscale, rows);\n",
         "  if (threadIdx.x < K) rows[threadIdx.x] = 1u << threadIdx.x;\n")],
    "vote without the tail": [
        ("consensus_vote.cu",
         "  if (tail) a = strata_prefix(s, p, bscale, hist, state, lane);\n", ""),
        ("consensus_vote.cu",
         "  if (tail) vote_finish(a, rows, p, state_out, go, diag, lane);\n", "")],
}


def _design() -> dict:
    f, mark = TWO_LAUNCH_MARK
    return TWO_LAUNCH if mark in (SRC / f).read_text() else ONE_LAUNCH


def _vote_design() -> dict:
    f, mark = VOTE_BLOCK_MARK
    return VOTE_BLOCK if mark in (SRC / f).read_text() else VOTE_WARP


def _stratified_design() -> dict:
    f, mark = STRATIFIED_GRID_MARK
    return STRATIFIED_GRID if mark in (SRC / f).read_text() else STRATIFIED_CLUSTER


def _variant_dir(name: str) -> Path:
    return OUT / "".join(c if c.isalnum() else "_" for c in name)


def build_all(variants: dict) -> dict:
    """Apply each variant's substitutions to its own copy of csrc/, start
    every nvcc at once, then link one library per variant. A variant that
    changes only ``.cu`` files compiles those and links the shipped
    objects of the others ("shipped", the variant without substitutions,
    must be in ``variants``). Each library's ``log`` holds its compilers'
    output, source by source."""
    nvcc = _build._nvcc()
    procs, own = [], {}
    for name, subs in variants.items():
        d = _variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        for f, old, new in subs:
            text = (d / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {f} no longer holds the text this variant removes")
            (d / f).write_text(text.replace(old, new))
        touched = {f for f, _, _ in subs}
        own[name] = (SOURCES if not subs or any(not f.endswith(".cu") for f in touched)
                     else tuple(s for s in SOURCES if s in touched))
        for s in own[name]:
            procs.append((name, s, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / f"{s}.o"), str(d / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {name: "" for name in variants}
    for name, s, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        logs[name] += f"[{s}]\n{log}"
    libs = {}
    shipped = _variant_dir("shipped")
    for name in variants:
        d = _variant_dir(name)
        so = d / "lib.so"
        objs = [(d if s in own[name] else shipped) / f"{s}.o" for s in SOURCES]
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *map(str, objs)], check=True, capture_output=True)
        libs[name] = _build.Library(so, logs[name], 0.0)
    return libs


def _ptxas_lines(log: str, source: str) -> list:
    """What ptxas printed of ``source``'s kernels: the stack, spill and
    register lines."""
    part = log.split(f"[{source}]\n", 1)
    if len(part) < 2:
        return []
    text = part[1].split("\n[", 1)[0]
    return [l.strip() for l in text.splitlines() if "stack frame" in l or "registers" in l]


def eigh_yardstick() -> None:
    """torch.linalg.eigh on the vote's (K 6) batch of 6x6 float64 normal
    matrices: the library's time for the eigensolve alone (it checks its
    status on the host, so only the profiler's device time and the per-call
    time with its synchronisation are taken)."""
    torch = cs.torch
    g = torch.Generator().manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn((6, 6, 6), generator=g, dtype=torch.float64))
    ev = torch.exp(torch.empty((6, 6), dtype=torch.float64).uniform_(4.6, 11.5, generator=g))
    a = (q * ev[:, None, :]) @ q.transpose(1, 2)
    a = ((a + a.transpose(1, 2)) / 2).cuda()
    prof = cs._device_ms(lambda: torch.linalg.eigh(a), reps=50) * 1e3
    call = cs._time_ms(lambda: torch.linalg.eigh(a)) * 1e3
    print(f"[variants] torch.linalg.eigh (6, 6, 6) float64: device {prof:.2f} us per call "
          f"(profiler), {call:.2f} us per call with its host synchronisation (CUDA events)")


def main() -> int:
    stratified_only = "--stratified" in sys.argv[1:]
    vote_only = "--vote" in sys.argv[1:]
    if not cs.torch.cuda.is_available():
        print("irls_variants: needs a CUDA card", file=sys.stderr)
        return 2
    cs.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    if vote_only:
        variants = {"shipped": [], **_vote_design()}
    else:
        variants = {"shipped": [], **({} if stratified_only else _design()),
                    **_stratified_design()}
    libs = build_all(variants)
    _build._LIBRARY = libs["shipped"]
    timing = []
    if vote_only:
        for name, lib in libs.items():
            print(f"[variants] ptxas, {name}: " + " | ".join(_ptxas_lines(lib.log,
                                                                         "consensus_vote.cu")))
        timing += cs.phase_consensus_vote(cs.phase_stratified()[3])[2]
    else:
        if not stratified_only:
            timing += cs.phase_kernels(cs.slice_config())[2] + cs.phase_ic_kernels()[2]
        timing += cs.phase_stratified()[2]
    print("[variants] device us per call, profiler (50 calls) / CUDA events (50 calls back to "
          "back): " + " | ".join(f"{key} {level}" for key, level, *_ in timing))
    for rnd in range(2):
        for name, lib in libs.items():
            _build._LIBRARY = lib
            row = []
            for _, _, kernel, _, args, *_ in timing:
                prof = cs._device_ms(lambda: kernel(args), reps=50) * 1e3
                ev = cs._event_device_ms(lambda: kernel(args)) * 1e3
                row.append(f"{prof:6.2f}/{ev:6.2f}")
            print(f"[variants] round {rnd} {name:42s} " + " ".join(row))
    if vote_only:
        eigh_yardstick()
    return 0


if __name__ == "__main__":
    sys.exit(main())
