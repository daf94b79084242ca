#!/usr/bin/env python3
"""On-card probes of the negscore forwards (biomedkg_tpu_torch/csrc/
negscore.cu, ops/negscore.py), beside the checks and times chip_smoke.py
makes. Run from the repo root on a CUDA machine:

    python scripts/negscore_fwd_probe.py checks     # every design vs plain
    python scripts/negscore_fwd_probe.py times      # device times, in turns
    python scripts/negscore_fwd_probe.py variants --set run

``checks``: every forward design against the plain version at odd shapes
(d of 6/7, 100 and 256, ids out of range, ns and nd in any order, a dst
band that wraps the id range, one id's run over many warps), float32 and
bf16, and the redesigns against ``lane_scores_plain`` (the kernels' own
order of sums) within 1e-5 of Σ|terms| in float32.
``times``: at the training envelope (2,944 node slots, 409,600 slots,
d = 256, R = 8, the samplers' negatives), each forward's device time
(torch.profiler, each kernel's mean record) per design in turns (new,
first, first, new), float32 and bf16, and the L2 gather yardstick: a
trivial kernel that gathers 409,600 random rows of z into a per-row dot
with a register-held vector, 8 rows in flight a warp. Its rate is what a
forward that gathers only t from L2 can reach.
``variants``: copies of negscore.cu with named edits (``VARIANTS``) built
under csrc/build, and the forward kernels of each timed alone, in turns.
The edits match the source text; an edit that no longer matches stops the
run. Each variant's registers and spills (ptxas) are printed.

Every timing line carries the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from biomedkg_tpu_torch.ops import _build, negscore  # noqa: E402
from chip_smoke import fwd_l2_bytes  # noqa: E402
from biomedkg_tpu_torch.training.kge_module import \
    sample_negatives_sorted  # noqa: E402

N, M, D, R = 2944, 409600, 256, 8     # the training envelope
ITERS = 20
TYPES = (torch.bfloat16, torch.float32)

# named edits of negscore.cu: {set: {variant: {old text: new text}}}
VARIANTS = {
    "run": {
        "as built": {},
        "float32 8 rows in flight": {
            "  constexpr int F = sizeof(T) == 4 ? kFwdRows / 2 : kFwdRows;":
                "  constexpr int F = kFwdRows;"},
        "no reduction (the 8 partials added)": {
            "        const float s = reduce_slots(acc);":
                "        const float s = acc[0] + acc[1] + acc[2] + acc[3] + "
                "acc[4] + acc[5] + acc[6] + acc[7];"},
        "no relation rows (ones)": {
            "  Q::to_float(S::read(rrow, packs, p), r0);":
                "  for (int v = 0; v < V; ++v) r0[v] = 1.f;",
            "    Q::to_float(S::read(rrow + off, packs, p), r1);":
                "    for (int v = 0; v < V; ++v) r1[v] = 1.f;"},
        "no t gathers (row 0)": {
            "  const T* row = z + (int64_t)id * d + p * V;":
                "  const T* row = z + p * V;"},
    },
    # the first design's dual-sorted forward taken apart
    "first ds": {
        "as built": {},
        "span + staging alone (no slot walk)": {
            "  for (int64_t s0 = c0 + warp * U; s0 < c1; s0 += kDsWarps * U)"
            " {":
                "  for (int64_t s0 = c0 + warp * U; s0 < c0; s0 += kDsWarps "
                "* U) {"},
        "span + slot walk (no staging)": {
            "  if (staged_s) stage_rows(z, lo_s, span[1] - lo_s + 1, d, "
            "rows_s);\n": "",
            "  if (staged_d) stage_rows(z, lo_d, span[3] - lo_d + 1, d, "
            "rows_d);\n": ""},
        "span alone": {
            "  if (staged_s) stage_rows(z, lo_s, span[1] - lo_s + 1, d, "
            "rows_s);\n": "",
            "  if (staged_d) stage_rows(z, lo_d, span[3] - lo_d + 1, d, "
            "rows_d);\n": "",
            "  for (int64_t s0 = c0 + warp * U; s0 < c1; s0 += kDsWarps * U)"
            " {":
                "  for (int64_t s0 = c0 + warp * U; s0 < c0; s0 += kDsWarps "
                "* U) {"},
    },
}

# the L2 gather yardstick: warp w gathers rows ids[begin..end) of z (d =
# 256: a lane's 8 features, 16 bytes in bf16, 32 in float32) and dots each
# with its register-held vector; 8 rows in flight, one shuffle sum a row
YARDSTICK = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out);

template <>
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    gather_dot(const T* __restrict__ z, const int32_t* __restrict__ ids,
               float* __restrict__ out, int m, int per_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * 256 + threadIdx.x) >> 5;
  float w[8];
  for (int k = 0; k < 8; ++k) w[k] = 1.f + 0.01f * (lane * 8 + k);
  const int begin = warp * per_warp;
  const int end = min(m, begin + per_warp);
  for (int s0 = begin; s0 < end; s0 += 8) {
    float x[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (s0 + u < end) load8(z + (int64_t)__ldg(ids + s0 + u) * 256 +
                              lane * 8, x[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) a += x[u][k] * w[k];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0 && s0 + u < end) out[s0 + u] = a;
    }
  }
}

extern "C" int yardstick(int bf16, const void* z, const void* ids,
                         void* out, int m, int blocks, void* stream) {
  const int warps = blocks * 8;
  const int per_warp = ((m + warps - 1) / warps + 7) / 8 * 8;
  if (bf16)
    gather_dot<__nv_bfloat16><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)z, (const int32_t*)ids, (float*)out, m,
        per_warp);
  else
    gather_dot<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)z, (const int32_t*)ids, (float*)out, m, per_warp);
  return (int)cudaGetLastError();
}
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_ms(fn) -> tuple:
    """(device ms of one call, {kernel: ms}) over ITERS calls: each
    kernel's mean time a record times its records a call (CUPTI drops a
    record now and then, so a window's total would read low)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    parts = {e.key[:48]: e.self_device_time_total / e.count / 1e3
             * max(1, round(e.count / ITERS))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.count}
    return sum(parts.values()), parts


def designs_of(dual: bool) -> tuple:
    """(the path's forward design, the first design) of a family."""
    return (negscore.negscore_fwd_design("distmult", dual, torch.bfloat16,
                                         D), "first")


def with_fwd_design(design, fn):
    saved = negscore.negscore_fwd_design
    negscore.negscore_fwd_design = lambda *_: design
    try:
        return fn()
    finally:
        negscore.negscore_fwd_design = saved


def path_inputs(mode, dtype, gen, dual):
    """z (L1-normalised for transe), ns, nd, rel and the kernels' table at
    the training envelope, the sampler's negatives."""
    dev = torch.device("cuda")
    z = torch.randn(N, D, device=dev, generator=gen).to(dtype)
    if mode == "transe":
        z = negscore.l1_normalized(z)
    ns, nd, _ = sample_negatives_sorted(
        gen, M // 40960, 40960, torch.tensor(N, device=dev), dual=dual)
    rel = torch.randint(0, R, (M,), device=dev, generator=gen).int()
    rel_emb = torch.randn(R, D // 2 if mode == "rotate" else D, device=dev,
                          generator=gen)
    re = negscore.relation_table(mode, rel_emb, dtype).contiguous()
    return z.contiguous(), ns, nd, rel, rel_emb, re


def yardstick_lib():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    folder = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    path = os.path.join(folder, "yardstick.cu")
    with open(path, "w") as f:
        f.write(YARDSTICK)
    _P, _I = ctypes.c_void_p, ctypes.c_int
    return _build.CudaLibrary(path, {"yardstick": [_I, _P, _P, _P, _I, _I,
                                                   _P]})


def yardstick(lib, z, ids):
    out = torch.empty(ids.shape[0], device=z.device)
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count

    def call():
        err = lib.lib().yardstick(int(z.dtype == torch.bfloat16),
                                  z.data_ptr(), ids.data_ptr(),
                                  out.data_ptr(), ids.shape[0], 2 * sms,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"yardstick launch failed: cudaError_t {err}")
    ms = device_ms(call)[0]
    want = z.float()[ids.long()] @ (1.0 + 0.01 * torch.arange(
        D, device=z.device, dtype=torch.float32))
    err = float((out - want).abs().max() / want.abs().max())
    return ms, err


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def case_inputs(mode, dtype, n, d, m, gen, case):
    """z, ns, nd, rel, rel_emb, re for one odd case."""
    dev = torch.device("cuda")

    def draw(lo, hi):
        return torch.randint(lo, hi, (m,), device=dev, generator=gen).int()
    z = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    ns, nd, rel = torch.sort(draw(-2, n + 3))[0], draw(-2, n + 3), draw(-1, 6)
    if case == "ns in any order":
        ns = draw(-2, n + 3)
    elif case == "band that wraps":
        nd = torch.remainder(n - 6 + draw(0, 12), n).int()
    elif case == "one src id over 3,000 slots":
        ns = torch.sort(torch.where(torch.arange(m, device=dev) < 3000, 7,
                                    draw(0, n)))[0].int()
    rel_emb = torch.randn(5, d // 2 if mode == "rotate" else d, device=dev,
                          generator=gen)
    re = negscore.relation_table(mode, rel_emb, dtype).contiguous()
    return z, ns, nd, rel, rel_emb, re


def checks(gen) -> bool:
    """Every forward design against the plain version at odd shapes (rel
    to max: float32 1e-4, bf16 2e-2), and in float32 the redesigns against
    ``lane_scores_plain`` within 1e-5 of Σ|terms| per slot."""
    print(card())
    print(f"negscore.cu: {forward_report(negscore.LIBRARY.build_log)}")
    if not negscore.LIBRARY.build_log:    # cached: build a fresh copy
        built_variants({"as built": {}})
    ok = True
    cases = ("ns sorted", "ns in any order", "band that wraps",
             "one src id over 3,000 slots")
    for mode in negscore.MODES:
        widths = (6, 100, 256) if mode in negscore.PAIRED else (7, 100, 128,
                                                                256)
        for dtype in TYPES:
            worst = {}
            for d in widths:
                for n, m in ((37, 5000), (300, 5000), (N, 40960)):
                    for case in cases:
                        z, ns, nd, rel, rel_emb, re = case_inputs(
                            mode, dtype, n, d, m, gen, case)
                        want = negscore.plain_scores(mode, z, ns, nd, rel,
                                                     rel_emb)
                        order = negscore.lane_scores_plain(mode, z, ns, nd,
                                                           rel, re)
                        terms = negscore.slot_terms(
                            mode, z[ns.long().clamp(0, n - 1)].float(),
                            z[nd.long().clamp(0, n - 1)].float(),
                            re[rel.long().clamp(0, 4)])
                        mag = terms.abs().sum(1).clamp(min=1e-30)
                        for dual in (False, True):
                            k = negscore.KERNELS[negscore.kernel_name(
                                mode, dual)]
                            for des in negscore.FWD_DESIGNS:
                                got = with_fwd_design(des, lambda: k(
                                    z, ns, nd, rel, re))
                                e = rel_err(got, want)
                                tol = (1e-4 if dtype == torch.float32
                                       else 2e-2)
                                if dtype == torch.float32 and des != "first":
                                    e2 = float(((got - order).abs()
                                                / mag).max())
                                    ok &= e2 <= 1e-5
                                    worst[des + " order"] = max(
                                        worst.get(des + " order", 0), e2)
                                ok &= e <= tol
                                worst[des] = max(worst.get(des, 0), e)
                                if e > tol:
                                    print(f"FAIL {k.name} {des} "
                                          f"{str(dtype)[6:]} d = {d}, N = "
                                          f"{n}, M = {m}, {case}: {e:.3g}")
            print(f"{mode} {str(dtype)[6:]} (d {widths}; N 37, 300, {N}; "
                  f"{', '.join(cases)}): worst rel-to-max "
                  + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    print("ALL OK" if ok else "SOME FAILED")
    return ok


def times(gen):
    print(card())
    lib = yardstick_lib()
    for dtype in TYPES:
        z = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
        ids = torch.randint(0, N, (M,), device="cuda", generator=gen).int()
        ms, err = yardstick(lib, z, ids)
        nbytes = M * D * z.element_size()
        print(f"L2 gather yardstick {str(dtype)[6:]}: {M} random rows of "
              f"z ({N} x {D}) dotted with a register-held vector, "
              f"{ms:.4f} ms (device), {nbytes / ms / 1e9:.2f} TB/s of rows "
              f"({nbytes / 1e6:.1f} MB); rel err {err:.2g}")
    for mode in negscore.MODES:
        for dual in (False, True):
            for dtype in TYPES:
                z, ns, nd, rel, _, re = path_inputs(mode, dtype, gen, dual)
                k = negscore.KERNELS[negscore.kernel_name(mode, dual)]
                designs = designs_of(dual)
                order = designs + tuple(reversed(designs))
                turns = [with_fwd_design(design, lambda: device_ms(
                    lambda: k(z, ns, nd, rel, re))[0]) for design in order]
                got = {des: [t for o, t in zip(order, turns) if o == des]
                       for des in designs}
                print(f"{k.name} {str(dtype)[6:]} forward (device ms): "
                      + "; ".join(
                          f"{des} {' / '.join(f'{t:.4f}' for t in ts)} "
                          f"(L2 gathers "
                          f"{fwd_l2_bytes(des, z, ns) / 1e6:.1f} MB, "
                          f"modelled)"
                          for des, ts in got.items()))


def built_variants(edits: dict) -> dict:
    """{name: CudaLibrary} of negscore.cu with each variant's edits."""
    source = open(negscore.LIBRARY.source).read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    folder = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    libraries = {}
    for i, (name, subs) in enumerate(edits.items()):
        text = source
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} not in the "
                                 f"source")
            text = text.replace(old, new)
        path = os.path.join(folder, f"negscore_fwd_variant_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        libraries[name] = _build.CudaLibrary(path,
                                             negscore.LIBRARY.signatures)
    with ThreadPoolExecutor(len(libraries)) as pool:   # nvcc in parallel
        list(pool.map(lambda lib: lib.lib(), libraries.values()))
    for name, lib in libraries.items():
        print(f"variant {name!r}: {forward_report(lib.build_log)}")
    return libraries


KERNEL = r"(run_fwd_kernel|ds_fwd_kernel|fwd_kernel)"


def forward_report(log: str) -> str:
    """The forward kernels' registers and spills from nvcc's ptxas report
    (none when the library came from the build cache: nvcc did not run)."""
    lines = log.splitlines()
    regs, spills, redesign = [], [], []
    for i, line in enumerate(lines[:-2]):
        if "Function properties for" in line and re.search(KERNEL + "I",
                                                            line):
            stores = re.search(r"(\d+) bytes spill stores", lines[i + 1])
            used = re.search(r"Used (\d+) registers", lines[i + 2])
            regs.append(int(used.group(1)) if used else -1)
            if "run_fwd" in line:
                kind = re.search(KERNEL + r"ILi(\d)E(\w+?)Li(\d)E", line)
                if kind:
                    kind_t = "bf16" if "bfloat" in kind.group(3) else "f32"
                    redesign.append(f"{kind.group(1)[:6]}<{kind.group(2)},"
                                    f"{kind_t},{kind.group(4)}>:{regs[-1]}")
            if stores and int(stores.group(1)):
                name = re.search(KERNEL + r"I\w{0,24}", line)
                spills.append(f"{name.group(0) if name else line} "
                              f"{stores.group(1)} B")
    if not regs:
        return "no ptxas report (cached build)"
    return (f"{len(regs)} forward kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers; spills: "
            f"{'; '.join(spills) if spills else 'none'}; registers of the "
            f"redesigns {' '.join(redesign)}")


def variants(gen, set_name: str):
    print(card())
    libraries = built_variants(VARIANTS[set_name])
    dual = set_name != "run"
    fn_name = {"first ds": "negscore_ds_fwd",
               "run": "negscore_run_fwd"}[set_name]
    chunk = [] if set_name == "run" else [negscore.BLOCK]
    for mode in negscore.MODES:
        for dtype in TYPES:
            z, ns, nd, rel, _, re = path_inputs(mode, dtype, gen, dual)
            out = torch.empty(M, device=z.device)
            kind = "f32" if dtype == torch.float32 else "bf16"

            def alone(lib):
                def call():
                    err = getattr(lib.lib(), f"{fn_name}_{kind}")(
                        negscore.MODES.index(mode), z.data_ptr(),
                        ns.data_ptr(), nd.data_ptr(), rel.data_ptr(),
                        re.data_ptr(), out.data_ptr(), M, N, D, R, *chunk,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"launch failed: cudaError_t {err}")
                return call
            got = {}
            for turn in (list(libraries.items()),
                         list(reversed(libraries.items()))):
                for name, lib in turn:
                    got.setdefault(name, []).append(device_ms(alone(lib))[0])
            print(f"{set_name}: {mode} {kind} forward alone, "
                  f"{'sorted2' if dual else 'sorted'} (device ms, two "
                  f"turns): " + "; ".join(
                      f"{name} {v[0]:.4f} / {v[1]:.4f}"
                      for name, v in got.items()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("checks", "times", "variants"))
    parser.add_argument("--set", choices=sorted(VARIANTS),
                        default="first ds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("negscore_fwd_probe: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    negscore.LIBRARY.lib()
    if args.what == "checks":
        return 0 if checks(gen) else 1
    if args.what == "times":
        times(gen)
    elif args.what == "variants":
        variants(gen, args.set)
    return 0


if __name__ == "__main__":
    sys.exit(main())
