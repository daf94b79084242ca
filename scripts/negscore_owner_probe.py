#!/usr/bin/env python3
"""On-card probes of the negscore backward's owner design
(biomedkg_tpu_torch/csrc/negscore.cu, ops/negscore.py), beside the checks
and times chip_smoke.py makes. Run from the repo root on a CUDA machine:

    python scripts/negscore_owner_probe.py checks     # owner vs plain, vs first
    python scripts/negscore_owner_probe.py times      # device times, in turns
    python scripts/negscore_owner_probe.py variants --set groups
    python scripts/negscore_owner_probe.py probe      # bucket build phases

``checks``: the bucket build against ``buckets_plain`` at odd and path
sizes, and every owner backward against the plain version (and the first
design) at odd widths with ids out of range, float32 and bf16.
``times``: at the training envelope (2,944 node slots, 409,600 slots,
d = 256, R = 8, the samplers' negatives), the device time of one whole
backward call (torch.profiler, kernels by name) in the owner and the first
design in turns (owner, first, first, owner), and the bucket kernel alone
at other sizes.
``variants``: copies of negscore.cu with named edits (``VARIANTS``) built
under csrc/build and the owner kernel of each timed alone, in turns,
under both samplers. The edits match the source text; an edit that no
longer matches stops the run.
``probe``: the bucket kernel with globaltimer stamps (block 0 and the last
block, thread 0) at its phase boundaries.

Every timing line carries the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from biomedkg_tpu_torch.ops import _build, negscore  # noqa: E402
from biomedkg_tpu_torch.training.kge_module import \
    sample_negatives_sorted  # noqa: E402

N, M, D, R = 2944, 409600, 256, 8     # the training envelope
ITERS = 20
# named edits of negscore.cu: {set: {variant: {old text: new text}}}
VARIANTS = {
    "groups": {f"{g} warps an id, {b} blocks an SM": {
        "constexpr int kGroupWarps = 4;": f"constexpr int kGroupWarps = {g};",
        "constexpr int kOwnBlocksPerSm = 2;":
            f"constexpr int kOwnBlocksPerSm = {b};"}
        for g, b in ((4, 2), (4, 3), (8, 2), (8, 3), (2, 2), (2, 3), (1, 2))},
    "float32 widths": {
        "8 floats a lane": {},
        "4 floats a lane": {
            "owner_vector(units, sizeof(float), z, dz, 8)":
                "owner_vector(units, sizeof(float), z, dz, 4)"}},
    "slots": {f"{u} slots in flight": {
        "constexpr int kOwnSlots = 4;": f"constexpr int kOwnSlots = {u};"}
        for u in (4, 2, 6, 8)},
    "ablations": {
        "as built": {},
        "no relation partial": {
            "          L::add(part + rk[u] * dr, packs, p, dr0);\n": "",
            "            L::add(part + rk[u] * dr + off, packs, p, dr1);\n":
                ";\n"},
        "no row gathers (row 0)": {
            "raw0[u] = R::load(z + (int64_t)row * d + j);":
                "raw0[u] = R::load(z + j);",
            "raw1[u] = R::load(z + (int64_t)row * d + off + j);":
                "raw1[u] = R::load(z + off + j);"},
        "no relation-row reads": {
            "        L::read(sre + rk[u] * d, packs, p, r0);":
                "        for (int q = 0; q < V; ++q) r0[q] = 1.f;",
            "          L::read(sre + rk[u] * d + off, packs, p, r1);":
                "          for (int q = 0; q < V; ++q) r1[q] = 1.f;"},
        "no dst walk": {
            "      owner_walk<M, T, V, false>(z, ns, rel, ds, ord + m, da, db,"
            " n, d, r,":
                "      if (n < 0) owner_walk<M, T, V, false>(z, ns, rel, ds, "
                "ord + m, da, db, n, d, r,"},
    },
}


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


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def inputs(mode, dtype, n, d, m, r, gen, dual=None, clip=0):
    """z, ns, nd, rel, the relation parameter and its table, ds: the
    samplers' negatives when ``dual`` is given, else uniform ids (``clip``
    of them out of range on each side) with ns sorted."""
    dev = torch.device("cuda")
    z = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    if dual is None:
        def ids(hi):
            return torch.randint(-clip, hi + clip, (m,), device=dev,
                                 generator=gen).int()
        ns, nd = torch.sort(ids(n))[0], ids(n)
    else:
        ns, nd, _ = sample_negatives_sorted(
            gen, m // 40960, 40960, torch.tensor(n, device=dev), dual=dual)
    rel = torch.randint(-min(clip, 1), r + min(clip, 1), (m,), device=dev,
                        generator=gen).int()
    rel_emb = torch.randn(r, d // 2 if mode == "rotate" else d, device=dev,
                          generator=gen)
    re = negscore.relation_table(mode, rel_emb, dtype).contiguous()
    ds = torch.randn(m, device=dev, generator=gen)
    return z, ns, nd, rel, rel_emb, re, ds


def with_design(design, fn):
    saved = negscore.negscore_design
    negscore.negscore_design = lambda *_: design
    try:
        return fn()
    finally:
        negscore.negscore_design = saved


def checks(gen):
    dev = torch.device("cuda")
    ok = True
    for m, n in ((1, 1), (100, 7), (5000, 37), (M, N), (70000, 9000),
                 (3001, 20000)):
        for sort_ns in (True, False):
            ns = torch.randint(-3, n + 3, (m,), device=dev,
                               generator=gen).int()
            ns = torch.sort(ns)[0] if sort_ns else ns
            nd = torch.randint(-3, n + 3, (m,), device=dev,
                               generator=gen).int()
            got = negscore.BUCKETS(ns, nd, n)
            want = negscore.buckets_plain(ns, nd, n)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= same
            print(f"buckets M = {m}, N = {n}, ns sorted {sort_ns}: "
                  f"{'ok' if same else 'FAIL'}")
    for mode in negscore.MODES:
        widths = (6, 100) if mode in negscore.PAIRED else (7, 100)
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-4 if dtype == torch.float32 else 3e-2
            for d in widths:
                z, ns, nd, rel, rel_emb, re, ds = inputs(
                    mode, dtype, 37, d, 5000, 5, gen, clip=2)
                zp = z.clone().requires_grad_(True)
                rp = rel_emb.clone().requires_grad_(True)
                s = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
                want = torch.autograd.grad(s, (zp, rp), ds)
                for dual in (False, True):
                    k = negscore.KERNELS[negscore.kernel_name(mode, dual)
                                         + "_bwd"]
                    for design in negscore.DESIGNS:
                        got = with_design(design, lambda: k(z, ns, nd, rel,
                                                            re, ds))
                        errs = [rel_err(a, b) for a, b in zip(got, want)]
                        ok &= max(errs) <= tol
                        print(f"{k.name} {design} {str(dtype)[6:]} d = {d}: "
                              f"dz {errs[0]:.3g}, d(rel) {errs[1]:.3g} "
                              f"(tol {tol:g})")
    print("ALL OK" if ok else "SOME FAILED")
    return ok


def times(gen):
    print(card())
    for mode in negscore.MODES:
        for dual in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                z, ns, nd, rel, _, re, ds = inputs(mode, dtype, N, D, M, R,
                                                   gen, dual=dual)
                k = negscore.KERNELS[negscore.kernel_name(mode, dual)
                                     + "_bwd"]
                turns = [with_design(design, lambda: device_ms(
                    lambda: k(z, ns, nd, rel, re, ds)))
                    for design in ("owner", "first", "first", "owner")]
                print(f"{k.name} {str(dtype)[6:]} (device ms): owner "
                      f"{turns[0][0]:.4f} / {turns[3][0]:.4f} "
                      f"{ {a: round(b, 4) for a, b in turns[0][1].items()} }"
                      f"; first {turns[1][0]:.4f} / {turns[2][0]:.4f}")
    dev = torch.device("cuda")
    for m, n in ((M, N), (M, 100), (M, 9000), (40960, N), (4096, N)):
        ns = torch.sort(torch.randint(0, n, (m,), device=dev,
                                      generator=gen).int())[0]
        nd = torch.randint(0, n, (m,), device=dev, generator=gen).int()
        ms, parts = device_ms(lambda: negscore.BUCKETS(ns, nd, n))
        bucket = sum(v for key, v in parts.items() if "bucket" in key)
        print(f"bucket kernel M = {m}, N = {n}: {bucket:.4f} ms (device)")


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
        path = os.path.join(folder, f"negscore_variant_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        libraries[name] = _build.CudaLibrary(path,
                                             negscore.LIBRARY.signatures)
    for name, lib in libraries.items():
        lib.lib()
        log = lib.build_log.splitlines()
        spills = [log[i + 1].strip() for i, line in enumerate(log[:-1])
                  if "owner_kernel" in line and "Function properties" in line
                  and not log[i + 1].strip().startswith("0 bytes stack")]
        print(f"variant {name!r}: {len(spills)} owner kernels with a stack "
              f"frame or spills {spills[:4]}")
    return libraries


def variants(gen, set_name: str):
    print(card())
    libraries = built_variants(VARIANTS[set_name])
    cases = (("distmult", torch.bfloat16, False),
             ("distmult", torch.bfloat16, True),
             ("rotate", torch.bfloat16, False),
             ("rotate", torch.bfloat16, True),
             ("transe", torch.float32, False))
    if set_name == "float32 widths":
        cases = tuple((mode, torch.float32, dual) for mode in negscore.MODES
                      for dual in (False, True))
    for mode, dtype, dual in cases:
        z, ns, nd, rel, rel_emb, re, ds = inputs(mode, dtype, N, D, M, R, gen,
                                                 dual=dual)
        off, order = negscore.BUCKETS(ns, nd, N)
        dre = torch.zeros(R, rel_emb.shape[1], device=z.device)
        dz = torch.empty_like(z)
        kind = "f32" if dtype == torch.float32 else "bf16"

        def owner_alone(lib):
            def call():
                err = getattr(lib.lib(), f"negscore_owner_bwd_{kind}")(
                    negscore.MODES.index(mode), z.data_ptr(), ns.data_ptr(),
                    nd.data_ptr(), rel.data_ptr(), re.data_ptr(),
                    ds.data_ptr(), off.data_ptr(), order.data_ptr(),
                    dz.data_ptr(), dre.data_ptr(), M, N, D, R,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"launch failed: cudaError_t {err}")
            return call
        got = {}
        for turn in (list(libraries.items()),
                     list(reversed(libraries.items()))):
            for name, lib in turn:
                got.setdefault(name, []).append(device_ms(owner_alone(lib))[0])
        print(f"owner kernel alone, {mode} {kind}, "
              f"{'sorted2' if dual else 'sorted'} (device ms, the faster of "
              f"two turns): " + "; ".join(f"{name} {min(v):.4f}"
                                          for name, v in got.items()))


PROBE = ("if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == "
         "gridDim.x - 1)) { unsigned long long t_; asm volatile(\"mov.u64 "
         "%0, %%globaltimer;\" : \"=l\"(t_)); g_probe[(blockIdx.x == 0 ? 0 : "
         "16) + {k}] = t_; }\n")
PHASES = ["start", "counted", "past barrier 1", "prefixed over blocks",
          "past barrier 2", "bases added", "placed (end)", "offsets scanned"]


def probe(gen):
    """The bucket kernel's phases, stamped by globaltimer."""
    print(card())
    lines = open(negscore.LIBRARY.source).read().splitlines(keepends=True)
    out, barriers = [], 0
    for line in lines:
        if line == "  for (int k0 = 0; k0 < n; k0 += cap)\n" and not barriers:
            out.append(PROBE.replace("{k}", "0"))
        if line == "  grid_barrier(bar, round);\n":
            out += [PROBE.replace("{k}", str(1 + 2 * barriers)), line,
                    PROBE.replace("{k}", str(2 + 2 * barriers))]
            barriers += 1
            continue
        if line.startswith("  // per key range: each (warp, key) counter"):
            out.append(PROBE.replace("{k}", "7"))
        if (line == "    for (int64_t s = t0; s < t1; s += 32 * kKeyChunks)"
                    " {\n" and barriers == 2):
            out.append(PROBE.replace("{k}", "5"))
        out.append(line)
    text = "".join(out)
    end = text.index("// Owner design: the backward")
    close = text.rindex("}\n", 0, end)
    text = text[:close] + PROBE.replace("{k}", "6") + text[close:]
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        "long long g_probe[32];\n", 1)
    text += ("\nextern \"C\" int negscore_probe(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, g_probe, "
             "sizeof(g_probe));\n}\n")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    folder = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    path = os.path.join(folder, "negscore_probe.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = _build.CudaLibrary(path, dict(negscore.LIBRARY.signatures,
                                        negscore_probe=[ctypes.c_void_p]))
    dev = torch.device("cuda")
    for m, n in ((M, N), (M, 100), (4096, N)):
        ns = torch.sort(torch.randint(0, n, (m,), device=dev,
                                      generator=gen).int())[0]
        nd = torch.randint(0, n, (m,), device=dev, generator=gen).int()
        blocks = negscore.bucket_blocks(m, dev)
        ints = torch.empty(2 * blocks * n + 4 * n + 2 + 2 * m,
                           dtype=torch.int32, device=dev)
        base = ints.data_ptr()
        for rep in range(3):
            bar = torch.zeros(1, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            err = lib.lib().negscore_buckets(
                ns.data_ptr(), nd.data_ptr(), m, n, blocks, base,
                base + 4 * 2 * blocks * n,
                base + 4 * (2 * blocks * n + 2 * n),
                base + 4 * (2 * blocks * n + 4 * n + 2), bar.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"launch failed: cudaError_t {err}")
            stamps = (ctypes.c_ulonglong * 32)()
            lib.lib().negscore_probe(ctypes.addressof(stamps))
            t0 = stamps[0]
            print(f"bucket phases M = {m}, N = {n}, call {rep} (µs from "
                  f"block 0's start): " + ", ".join(
                      f"{name} {(stamps[k] - t0) / 1e3:.1f} / "
                      f"{(stamps[16 + k] - t0) / 1e3:.1f}"
                      for k, name in enumerate(PHASES)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("checks", "times", "variants",
                                         "probe"))
    parser.add_argument("--set", choices=sorted(VARIANTS), default="groups")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("negscore_owner_probe: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    negscore.LIBRARY.lib()
    if args.what == "checks":
        return 0 if checks(gen) else 1
    if args.what == "times":
        times(gen)
    elif args.what == "variants":
        variants(gen, args.set)
    else:
        probe(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
