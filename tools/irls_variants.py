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
place of the last block publishing the sums. The script reads which
design its sources hold: run from a checkout of an earlier commit (copy
this file into its ``tools/``), it times that commit's design.
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


def _design() -> dict:
    f, mark = TWO_LAUNCH_MARK
    return TWO_LAUNCH if mark in (SRC / f).read_text() else ONE_LAUNCH


def _variant_dir(name: str) -> Path:
    return OUT / "".join(c if c.isalnum() else "_" for c in name)


def build_all(variants: dict) -> dict:
    """Apply each variant's substitutions to its own copy of csrc/, start
    every nvcc at once, then link one library per variant."""
    nvcc = _build._nvcc()
    procs = []
    for name, subs in variants.items():
        d = _variant_dir(name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        for f, old, new in subs:
            text = (d / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {f} no longer holds the text this variant removes")
            (d / f).write_text(text.replace(old, new))
        for s in SOURCES:
            procs.append((name, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / f"{s}.o"), str(d / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
    libs = {}
    for name in variants:
        d = _variant_dir(name)
        so = d / "lib.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *(str(d / f"{s}.o") for s in SOURCES)], check=True, capture_output=True)
        libs[name] = _build.Library(so, "", 0.0)
    return libs


def main() -> int:
    if not cs.torch.cuda.is_available():
        print("irls_variants: needs a CUDA card", file=sys.stderr)
        return 2
    cs.phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    variants = {"shipped": [], **_design()}
    libs = build_all(variants)
    _build._LIBRARY = libs["shipped"]
    _, _, esm = cs.phase_kernels(cs.slice_config())
    _, _, ic = cs.phase_ic_kernels()
    timing = esm + ic
    print("[variants] device us per call (profiler, 50 calls): "
          + " | ".join(f"{key} {level}" for key, level, *_ in timing))
    for rnd in range(2):
        for name, lib in libs.items():
            _build._LIBRARY = lib
            row = [cs._device_ms(lambda: kernel(args), reps=50) * 1e3
                   for _, _, kernel, _, args, *_ in timing]
            print(f"[variants] round {rnd} {name:42s} " + " ".join(f"{x:7.2f}" for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
