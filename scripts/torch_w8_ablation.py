#!/usr/bin/env python3
"""Where the wide ScaledW8 tile's time goes above 64 rows: Kernel B
(``csrc/w8_gemm.cu`` on the 128-row tile of ``csrc/w8_tile128.cuh``), or
with ``--stack`` / ``--grouped`` Kernels F (``csrc/w8_stack.cu``) and I
(``csrc/w8_grouped.cu``) on the same tile, timed whole and with one part
of its mainloop cut out, each variant built from a patched copy of the
sources.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_w8_ablation.py [--splits | --stack | --grouped |
                                          --residual [--source DIR]]

Variants: ``base`` (the sources as they are), ``nodecode`` (no code
decode in the loop: the MMAs read a stale tile), ``nomma`` (no
tensor-core product), ``noload`` (no copies after the ring's first
fill), ``nodecode_nomma``, ``empty`` (no decode, MMAs or refill copies:
launch, prologue, epilogue and any pass over the partials); ``stages3`` a
3-stage ring; ``bn128`` the same
loop on 128 x 128 tiles of 64 x 32 warp tiles, 128-deep steps and a
3-stage ring (the tile's first shape), whole
and as ``bn128_nodecode_nomma``.  Outputs of the variants that cut a
part out are wrong by design; only their time means anything.  Beside
them ``matmul``: ``torch.matmul`` of the same activation and the weight
dequantized to bf16 beforehand.  Times
are medians of CUDA-event readings with the L2 flushed
(``chip_smoke.Timer``), at the prefill shapes ``chip_smoke.py`` checks.
Prints one line per shape; the copies and libraries go to
``build/ablation_w8/`` (gitignored).

``--splits`` instead times the sources as they are with every K split
(``d``: each divisor, at most 16, of the 128-deep K steps) at prefill
row counts of o and down, beside the split ``w8_gemm_split`` picks.

``--stack`` times the stacked GEMM alone (``w8_stack_gemm`` on a site
image) at q|k|v and gate|up of Llama-3.1-8B (K=4096) at 128 and 512 rows,
and ``--grouped`` the grouped GEMM alone (``w8_grouped_gemm``) at
Mixtral-8x7B's w1|w3 (K=4096) and w2 (K=14336), 8 experts, 128 rows
each: the variants above from ``base`` to ``empty``, and the base
sources with every K split.

``--residual`` times Kernel G alone (``csrc/w8_pair.cu``, the decode-row
strip of ``csrc/w8_rows.cuh``) at Llama-3.1-8B's o (N=4096 K=4096) and
down (N=4096 K=14336), M = 8 and 16, on a site image with h_in and no
bias: ``base``, ``nodecode`` (the raw code words as MMA operands),
``nomma`` (no tensor-core product: the decoded words folded into the
accumulators by xor), ``noepilogue`` (no cross-warp sum, close or store:
the accumulators kept alive by a test that never holds), ``empty`` (the
launch returns at once), ``ldcs`` (the codes loaded with the
streaming hint but no 256-byte L2 fetch), ``ldg`` (with neither),
``stages2`` and ``stages4`` (the register ring's depth, built 6 at M = 8
and 4 at M = 16) and ``stages8`` (8 at M = 8),
each beside the bound (codes, image, h_in and h_mid once over
3.35 TB/s), the same call on w8_tile.cuh's tile (``tile``), torch.addmm
on the bf16 weight image and a read of the codes alone (``max`` of their
int32 words), once with chip_smoke.Timer's flush (writing 256 MB, so the
L2 holds dirty lines that the kernel's misses write back) and once
flushing by a read of the same buffer.  With
``--source DIR`` (a ``csrc`` directory, e.g. the parent commit unpacked
by ``git archive`` into ``build/parent``) that tree's G is timed in the
same call, with its own arguments where it is the older tile kernel with
a partial pass.  It also times the strip at Kernel B's decode-row shapes
(M=8, N=14336 K=4096 and N=4096 K=14336) beside B itself.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import shutil
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from micromix_tpu_torch.kernels import build  # noqa: E402
from micromix_tpu_torch.kernels.fakequant import fakequant_values  # noqa: E402
from micromix_tpu_torch.mx.scaledw8 import dequantize_scaled_w8  # noqa: E402

mm = importlib.import_module("micromix_tpu_torch.kernels.mixed_matmul")

MMA = ("          ptx::mma(acc[mt][2 * np], afrag, bfrag[np][0], bfrag[np][1]);\n",
       "          ptx::mma(acc[mt][2 * np + 1], afrag, bfrag[np][2], bfrag[np][3]);\n")
DECODE = ("      if (more && kk % (BK / 16 / DC) == 0) "
          "decode(raw_next, ws_next, kk / (BK / 16 / DC));\n")
NARROW = [("constexpr int BM = 128, BN = 256, BK = 64;",
           "constexpr int BM = 128, BN = 128, BK = 128;")]
REFILL = ("    if (t + STAGES - 1 < tend) "
          "load(t + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1);\n")
STAGES3 = [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]
VARIANTS = {
    "base": [],
    "nodecode": [(DECODE, "")],
    "nomma": [(m, "") for m in MMA],
    "noload": [(REFILL, "")],
    "nodecode_nomma": [(DECODE, "")] + [(m, "") for m in MMA],
    "empty": [(DECODE, ""), (REFILL, "")] + [(m, "") for m in MMA],
    "stages3": STAGES3,
    "bn128": NARROW + STAGES3,
    "bn128_nodecode_nomma": NARROW + STAGES3 + [(DECODE, "")] + [(m, "") for m in MMA],
}
SHAPES = ((512, 14336, 4096), (512, 4096, 4096), (512, 4096, 14336),
          (128, 4096, 4096), (1023, 4096, 14336))
# variants of the stack and grouped forms (their tile is B's as it is)
WIDE_VARIANTS = ("base", "nodecode", "nomma", "noload", "nodecode_nomma", "empty")
STACK_SHAPES = (("q|k|v", (4096, 1024, 1024), 128), ("gate|up", (14336, 14336), 128),
                ("q|k|v", (4096, 1024, 1024), 512))
GROUPED_SHAPES = (("w13", (14336, 14336), 4096, 128), ("w2", (4096,), 14336, 128))


def build_variants(out_dir: str, source: str = "w8_gemm", sig=None,
                   names=None) -> dict:
    sig = sig or mm._SIG
    procs = []
    for name, patches in VARIANTS.items():
        if names is not None and name not in names:
            continue
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        tile = os.path.join(d, "w8_tile128.cuh")
        src = open(tile).read()
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"{name}: w8_tile128.cuh no longer has {old.strip()!r}")
            src = src.replace(old, new)
        with open(tile, "w") as f:
            f.write(src)
        lib = os.path.join(d, f"lib{source}.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, f"{source}.cu")])))
    libs = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        libs[name] = ctypes.CDLL(lib)
        fn = getattr(libs[name], source)
        fn.argtypes = sig[source]
        fn.restype = ctypes.c_int
    return libs


def _every_split(timer, k, fn) -> str:
    """The base sources with every K split (divisors of the 128-deep steps)."""
    pick = mm.w8_gemm_split
    row = []
    try:
        for d in (d for d in range(1, min(k // 128, 16) + 1) if (k // 128) % d == 0):
            mm.w8_gemm_split = lambda *_, d=d: d
            row.append(f"d{d}={timer.ms(fn):.4f}")
    finally:
        mm.w8_gemm_split = pick
    return " ".join(row)


def ablate_wide(timer, grouped: bool) -> None:
    """Kernel F or I alone on a site image, every variant and every split."""
    import torch
    from micromix_tpu_torch.mx.scaledw8 import group_scaled_w8, stack_scaled_w8
    source = "w8_grouped" if grouped else "w8_stack"
    libs = build_variants(os.path.join(os.path.dirname(build.BUILD_DIR), f"ablation_{source}"),
                          source, mm._SIG_GROUPED if grouped else mm._SIG_STACK,
                          WIDE_VARIANTS)
    if grouped:
        cases = []
        for name, ns, k, c in GROUPED_SHAPES:
            splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
            gw = group_scaled_w8([[cs._w8_weight(n, k, splits) for _ in range(8)] for n in ns])
            img = fakequant_values(torch.randn(8 * c, k, device=cs.DEV), *splits).reshape(8, c, k)
            cases.append((f"{name} E=8 C={c} K={k}", k, lambda img=img, gw=gw: mm.w8_grouped_gemm(img, gw)))
    else:
        cases = []
        for name, ns, m in STACK_SHAPES:
            st = stack_scaled_w8([cs._w8_weight(n, 4096, cs.SPLIT_4096) for n in ns])
            img = fakequant_values(torch.randn(m, 4096, device=cs.DEV), *cs.SPLIT_4096)
            cases.append((f"{name} M={m} K=4096", 4096, lambda img=img, st=st: mm.w8_stack_gemm(img, st)))
    for label, k, fn in cases:
        row = []
        for name, lib in libs.items():
            build._libs[source] = lib
            row.append(f"{name}={timer.ms(fn):.4f}")
        build._libs[source] = libs["base"]
        print(f"{source} {label} ms: " + " ".join(row), flush=True)
        print(f"{source} {label} splits ms: " + _every_split(timer, k, fn), flush=True)


CODE_LOAD = ("  asm(\"ld.global.cs.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\\n\"\n"
             "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));")
RESIDUAL_VARIANTS = {
    "base": [],
    "nodecode": [("w8_rows.cuh", "  uint32_t x;\n  asm(\"prmt", "  return w;\n  uint32_t x;\n  asm(\"prmt")],
    "nomma": [("w8_rows.cuh",
               "          for (int mt = 0; mt < MT; ++mt) ptx::mma(acc[mt][nt], a[mt], b0, b1);",
               "          for (int mt = 0; mt < MT; ++mt)\n"
               "            acc[mt][nt][0] = __uint_as_float(__float_as_uint(acc[mt][nt][0]) ^ a[mt][0]"
               " ^ a[mt][1] ^ a[mt][2] ^ a[mt][3] ^ b0 ^ b1);")],
    "noepilogue": [("w8_pair.cu", "  w8r::block_sums<NT>(",
                    "  if (c.M > 0) {\n    float t = 0.0f;\n"
                    "    for (int i = 0; i < w8r::MT; ++i)\n      for (int j = 0; j < NT; ++j)\n"
                    "        for (int r = 0; r < 4; ++r) t += acc[i][j][r];\n"
                    "    if (t == 1.2345f) c.h_mid[threadIdx.x] = __float2bfloat16_rn(t);\n"
                    "    return;\n  }\n  w8r::block_sums<NT>(")],
    "empty": [("w8_pair.cu", "  const int chunks = K / w8r::CK;\n",
               "  const int chunks = K / w8r::CK;\n  if (scale != 0.0f) return;\n")],
    "ldcs": [("w8_rows.cuh", CODE_LOAD, "  v = __ldcs(reinterpret_cast<const uint4*>(p));")],
    "ldg": [("w8_rows.cuh", CODE_LOAD, "  v = __ldg(reinterpret_cast<const uint4*>(p));")],
    "stages2": [("w8_rows.cuh", "return NT == 1 ? 6 : 4;", "return 2;")],
    "stages4": [("w8_rows.cuh", "return NT == 1 ? 6 : 4;", "return 4;")],
    "stages8": [("w8_rows.cuh", "return NT == 1 ? 6 : 4;", "return NT == 1 ? 8 : 4;")],
}
RESIDUAL_SHAPES = (("o", 8, 4096, 4096), ("o", 16, 4096, 4096),
                   ("down", 8, 4096, 14336), ("down", 16, 4096, 14336))
# the parent's G: (a, codes, h_in, bias, h_mid, partial, M, N, K, scale,
# splits, stream), partials summed by a second launch
PARTIAL_PASS_SIG = [build.PTR] * 6 + [build.INT] * 3 + [build.FLOAT, build.INT, build.PTR]


def build_residual(src_dir: str, out_dir: str, variants) -> dict:
    """{variant: ctypes function of the given csrc tree's w8_pair.cu}, each
    built from a patched copy; the function's kind: "rows" (this tree's
    strip) or "partial" (the older tile kernel)."""
    newer = "w8_residual_rows" in open(os.path.join(src_dir, "w8_pair.cu")).read()
    procs = []
    for name, patches in variants.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        for fname, old, new in patches:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"{name}: {fname} no longer has {old.strip()!r}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        lib = os.path.join(d, "libw8_pair.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "w8_pair.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"{name}: nvcc failed")
        fn = getattr(ctypes.CDLL(lib), "w8_residual_rows" if newer else "w8_residual")
        fn.argtypes = mm._RESIDUAL_ARGS if newer else PARTIAL_PASS_SIG
        fn.restype = ctypes.c_int
        fns[name] = (fn, "rows" if newer else "partial")
    return fns


class ReadFlushTimer(cs.Timer):
    """chip_smoke.Timer with the L2 flushed by reading the 256 MB buffer,
    not writing it: the L2 then holds clean lines, and a kernel's misses
    evict them without writing them back to device memory first."""

    def ms(self, fn, iters: int = cs.TIMED_ITERS) -> float:
        import torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.view(torch.int64).max()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _residual_call(fn, kind, qa, wa, h, out):
    import torch
    m, k = qa.shape
    n = wa.rows
    if kind == "rows":
        _, splits = mm.residual_plan(m, n, k, "rows")
        tickets, partial = mm._residual_buffers(qa.device, n, splits * m * n)
        args = (build.ptr(partial), build.ptr(tickets))
    else:
        splits = mm.split_k(m, n, k)
        partial = torch.empty(splits * m * n, device=qa.device)
        args = (build.ptr(partial),)

    def run():
        build.check(fn(build.ptr(qa), build.ptr(wa.codes), build.ptr(h), 0,
                       build.ptr(out), *args, m, n, k, mm.w8_scale(wa), splits,
                       build.stream()), "w8_pair")
    return run


def ablate_residual(sources) -> None:
    import torch
    root = os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_residual")
    trees = {"this tree": build_residual(str(build.CSRC), os.path.join(root, "src0"),
                                         RESIDUAL_VARIANTS)}
    for i, src in enumerate(sources):
        trees[src] = build_residual(src, os.path.join(root, f"src{i + 1}"),
                                    {"base": []})
    timers = {"write flush": cs.Timer(), "read flush": ReadFlushTimer()}
    for name, m, n, k in RESIDUAL_SHAPES:
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        wa = cs._w8_weight(n, k, splits)
        wd = dequantize_scaled_w8(wa, torch.bfloat16)
        qa = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        h = torch.randn(m, n, device=cs.DEV).to(torch.bfloat16)
        out = torch.empty_like(h)
        words = wa.codes.view(torch.int32)
        nbytes = n * k + m * k * 2 + 2 * m * n * 2
        for tname, timer in timers.items():
            for label, fns in trees.items():
                row = [f"{v}={timer.ms(_residual_call(fn, kind, qa, wa, h, out)):.4f}"
                       for v, (fn, kind) in fns.items()]
                if label == "this tree":
                    row.append("tile=%.4f" % timer.ms(
                        lambda: mm.w8_residual_routed(qa, wa, h, None, "tile")))
                    row.append("addmm=%.4f" % timer.ms(lambda: torch.addmm(h, qa, wd.t())))
                    row.append("read_codes=%.4f" % timer.ms(lambda: words.max()))
                print(f"G [{label}] {name} M={m} N={n} K={k} {tname} ms: " + " ".join(row)
                      + f" bound={nbytes / cs.PEAK_BYTES_S * 1e3:.4f}", flush=True)
        del wa, wd
    timer = timers["write flush"]
    for m, n, k in ((8, 14336, 4096), (8, 4096, 14336)):
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        w = cs._w8_weight(n, k, splits)
        a = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        h = torch.zeros(m, n, device=cs.DEV, dtype=torch.bfloat16)
        strip = timer.ms(lambda: mm.w8_residual_routed(a, w, h, None, "rows"))
        b = timer.ms(lambda: mm.mixed_matmul_w8(a, w))
        nbytes = n * k + m * k * 2 + m * n * 2
        print(f"B's decode rows on G's strip: M={m} N={n} K={k} strip={strip:.4f} "
              f"B={b:.4f} bound={nbytes / cs.PEAK_BYTES_S * 1e3:.4f}", flush=True)
        del w


SPLIT_SHAPES = ((65, 4096, 4096), (128, 4096, 4096), (128, 4096, 14336),
                (129, 4096, 4096), (256, 4096, 4096), (300, 4096, 14336),
                (512, 4096, 4096), (512, 4096, 14336), (512, 14336, 4096),
                (1023, 4096, 4096))


def sweep_splits(timer) -> None:
    import torch
    for m, n, k in SPLIT_SHAPES:
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        w = cs._w8_weight(n, k, splits)
        a = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        print(f"M={m} N={n} K={k} picked d{mm.w8_gemm_split(m, n, k)} ms: "
              + _every_split(timer, k, lambda: mm.mixed_matmul_w8(a, w)), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_w8_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    if "--splits" in sys.argv[1:]:
        sweep_splits(cs.Timer())
        return 0
    args = sys.argv[1:]
    if "--residual" in args:
        ablate_residual([args[i + 1] for i, a in enumerate(args) if a == "--source"])
        return 0
    if "--stack" in sys.argv[1:] or "--grouped" in sys.argv[1:]:
        ablate_wide(cs.Timer(), "--grouped" in sys.argv[1:])
        return 0
    libs = build_variants(os.path.join(os.path.dirname(build.BUILD_DIR), "ablation_w8"))
    timer = cs.Timer()
    for m, n, k in SHAPES:
        splits = cs.SPLIT_4096 if k == 4096 else cs.SPLIT_14336
        w = cs._w8_weight(n, k, splits)
        a = fakequant_values(torch.randn(m, k, device=cs.DEV), *splits)
        wd = dequantize_scaled_w8(w, torch.bfloat16)
        row = []
        for name, lib in libs.items():
            build._libs["w8_gemm"] = lib
            row.append(f"{name}={timer.ms(lambda: mm.mixed_matmul_w8(a, w)):.4f}")
        row.append(f"matmul={timer.ms(lambda: torch.matmul(a, wd.t())):.4f}")
        print(f"M={m} N={n} K={k} splits={mm.w8_gemm_split(m, n, k)} ms: "
              + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
