"""The MX GEMMs: ScaledW8 (per consumer, stacked, the residual pair, the
MoE experts' grouped form) and split-plane (per consumer and stacked).

Counterpart of ``micromix_tpu/kernels/mixed_matmul.py``: ``mixed_matmul``
(dispatch by weight layout and M), for ScaledW8 ``mixed_matmul_w8`` (the
decode GEMM, CUDA kernel ``csrc/w8_gemm.cu``), ``mixed_matmul_w8_site``,
``mixed_matmul_w8_stack`` (``csrc/w8_stack.cu``),
``mixed_matmul_w8_pair`` (``csrc/w8_pair.cu``) and
``mixed_matmul_w8_grouped`` (``csrc/w8_grouped.cu``); for split-plane
weights (``MixedTensor``, fp4 packed) ``mixed_matmul_sp`` (MX activation
codes, ``csrc/sp_gemm.cu``) and ``mixed_matmul_sp_stack``
(``csrc/sp_stack.cu``).  Each runs its kernels on CUDA tensors and its
plain version on CPU tensors.

On the GPU a site runs as its own launch (the site kernel), whose output is
the bf16 image the GEMMs consume: the 32-blocks of the interleaved layout
span a whole segment of the row, so one GEMM output tile cannot cheaply own
its site.  So ``mixed_matmul_w8_site``, ``mixed_matmul_w8_stack``,
``mixed_matmul_w8_grouped`` and ``mixed_matmul_sp_stack`` are two launches
each, and ``mixed_matmul_w8_pair`` four: site A, the GEMM that closes the
residual (Kernel G, one launch at every row count: a K split, where there
is one, is summed by the last block of each strip or tile), then the
stack's site and GEMM.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..mx.mxtensor import (MixedTensor, SplitPlaneStack,
                           dequantize_mixed_device, section_mixed)
from ..mx.scaledw8 import (GroupedW8, ScaledW8, ScaledW8Stack,
                           dequantize_scaled_w8, grouped_section,
                           section_weight)
from . import build
from .fakequant import fakequant_site, fakequant_site_plain

# From this M on, the weight is dequantized to bf16 and the product left to
# torch.matmul, as the JAX package leaves it to XLA.
W8_PREFILL_DEQUANT_THRESHOLD = 1024
# Rows up to which a ScaledW8 stack runs the stacked GEMM (Kernel F), and
# rows per group up to which the experts run the grouped GEMM (Kernel I);
# above, their callers dequantize and multiply in one dense product.  The
# JAX package stops both at PALLAS_FAKEQUANT_MAX_M (128), where its TPU
# kernels stop; on the H100 the wide tile beats the dequantize route at
# every measured row count up to 512 and the q|k|v stack loses at 1023
# (the route table of chip_smoke.py; PERF.md).  On the CPU both routes
# are the same plain f32 product rounded once.
W8_STACK_MAX_M = 512
GROUPED_MAX_C = 512

_SMS = 132          # H100 SXM streaming multiprocessors
_BN, _BK = 64, 128  # csrc/w8_tile.cuh tile sizes
_BM_WIDE, _BN_WIDE = 128, 256   # csrc/w8_tile128.cuh: B's, F's and I's tiles above 64 rows
_W8_BLOCK_FIXED_STEPS = 3.4      # a wide block's fixed cost, in 128-deep steps
_W8_PARTIAL_BYTES_PER_STEP = 2.0e7   # partials written and read in one step's time
_SIG = {"w8_gemm": [build.PTR, build.PTR, build.PTR, build.PTR, build.INT,
                    build.INT, build.INT, build.FLOAT, build.INT, build.PTR]}
_SIG_STACK = {"w8_stack": [build.PTR, build.PTR, build.PTR, build.INTS,
                           build.INTS, build.INTS, build.FLOATS, build.PTRS,
                           build.INT, build.INT, build.INT, build.INT,
                           build.PTR]}
_RESIDUAL_ARGS = [build.PTR] * 7 + [build.INT] * 3 + [build.FLOAT, build.INT, build.PTR]
_SIG_PAIR = {"w8_residual_rows": _RESIDUAL_ARGS, "w8_residual_tile": _RESIDUAL_ARGS}
_SIG_GROUPED = {"w8_grouped": [build.PTR, build.PTR, build.PTR, build.INTS,
                               build.INTS, build.INTS, build.FLOATS,
                               build.PTRS, build.INT, build.INT, build.INT,
                               build.INT, build.INT, build.PTR]}
_MAX_SECTIONS = 4   # csrc/w8_stack.cu, csrc/w8_grouped.cu
_MAX_GROUPS = 64    # csrc/w8_grouped.cu


def w8_scale(w: ScaledW8) -> float:
    """2^(base+126): rescales the unbiased decode pattern to the value."""
    return 2.0 ** (w.base + 126)


def _check_gemm_operands(name: str, a: torch.Tensor, codes: torch.Tensor):
    if a.dtype != torch.bfloat16 or codes.dtype != torch.uint8:
        raise ValueError(f"{name} takes bf16 activations, u8 codes")
    if a.shape[1] % _BK:
        raise ValueError(f"{name} needs K % {_BK} == 0, got {a.shape[1]}")


def wide_tiles(sections) -> Tuple[int, ...]:
    """The wide tiles (``_BN_WIDE`` weight rows) of a stack or grouped
    weight, numbered per section so that no tile straddles two: section i
    owns tiles ``[t[i], t[i + 1])``, ceil(rows_i / ``_BN_WIDE``) of them,
    and ``t[-1]`` is the grid's width.  Kernels F and I above 64 rows."""
    t = [0]
    for n in sections:
        t.append(t[-1] + -(-n // _BN_WIDE))
    return tuple(t)


def _partials(splits: int, m: int, n: int, device) -> Optional[torch.Tensor]:
    return (torch.empty((splits, m, n), dtype=torch.float32, device=device)
            if splits > 1 else None)


def mixed_matmul_w8_plain(a: torch.Tensor, w: ScaledW8) -> torch.Tensor:
    """Y = A . dq(W)^T in f32, rounded to bf16 (the kernel's function)."""
    wd = dequantize_scaled_w8(w, torch.float32)
    return torch.matmul(a.to(torch.float32), wd.t()).to(torch.bfloat16)


def split_k(m: int, n: int, k: int) -> int:
    """K splits of the 16- and 64-row ScaledW8 tile (``w8_tile.cuh``), so
    that the GEMM has about two blocks per SM: the smallest divisor of the
    128-deep K steps (at most 16) that gets there."""
    bm = 16 if m <= 16 else 64
    tiles = -(-n // _BN) * -(-m // bm)
    steps = k // _BK
    divisors = [d for d in range(1, min(steps, 16) + 1) if steps % d == 0]
    return next((d for d in divisors if tiles * d >= 2 * _SMS), divisors[-1])


def w8_gemm_split(m: int, n: int, k: int) -> int:
    """K splits of Kernel B: ``split_k`` up to 64 rows; above, where B runs
    its 128 x 256 tile (``w8_tile128.cuh``, one 8-warp block per SM), the
    divisor d of the 128-deep K steps (at most 16) of least modelled time:
    waves of blocks times each block's steps plus its fixed cost, plus the
    pass over the f32 partials.  The model's two constants were fitted to
    the H100's times over d (``scripts/torch_w8_ablation.py --splits``)."""
    if m <= 64:
        return split_k(m, n, k)
    tiles = -(-n // _BN_WIDE) * -(-m // _BM_WIDE)
    steps = k // _BK

    def cost(d: int) -> float:          # in 128-deep steps of one block
        waves = -(-tiles * d // _SMS)
        partials = d * m * n * 8 / _W8_PARTIAL_BYTES_PER_STEP if d > 1 else 0.0
        return waves * (steps / d + _W8_BLOCK_FIXED_STEPS) + partials

    return min((d for d in range(1, min(steps, 16) + 1) if steps % d == 0), key=cost)


def mixed_matmul_w8(a: torch.Tensor, w: ScaledW8) -> torch.Tensor:
    """Y (M, N) bf16 = A (M, K) bf16 . decode(W)^T, f32 accumulation.

    ``a`` is the exact bf16 image of the quantized activation in device
    column order.
    """
    m, k = a.shape
    n = w.rows
    if w.k != k:
        raise ValueError(f"K mismatch: activation {k}, weight {w.k}")
    if not a.is_cuda:
        return mixed_matmul_w8_plain(a, w)
    _check_gemm_operands("mixed_matmul_w8", a, w.codes)
    if n % 8:
        raise ValueError(f"mixed_matmul_w8 needs N % 8 == 0, got {n}")
    a = a.contiguous()
    build.require_cuda("mixed_matmul_w8", a, w.codes)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m == 0:
        return out
    splits = w8_gemm_split(m, n, k)
    partial = _partials(splits, m, n, a.device)
    lib = build.library("w8_gemm", _SIG)
    build.launches["w8_gemm"] += 1
    rc = lib.w8_gemm(build.ptr(a), build.ptr(w.codes), build.ptr(out),
                     build.ptr(partial), m, n, k, w8_scale(w), splits,
                     build.stream())
    build.check(rc, "w8_gemm")
    return out


def mixed_matmul(a, w) -> torch.Tensor:
    """Y (M, N) bf16 = dq(A) . dq(W)^T.

    ScaledW8 ``w``: ``a`` is the bf16 activation image (or a MixedTensor,
    decoded to it); below ``W8_PREFILL_DEQUANT_THRESHOLD`` rows the
    ScaledW8 GEMM, from it on a one-shot dequant to bf16 and one dense
    product.  Split-plane ``w`` (MixedTensor): ``a`` a MixedTensor of
    activation codes; below ``PREFILL_DEQUANT_THRESHOLD`` rows the
    split-plane GEMM, from it on both operands dequantized and one dense
    product.
    """
    if isinstance(w, MixedTensor):
        if a.rows >= PREFILL_DEQUANT_THRESHOLD:
            if not a.fp4.is_cuda:
                return mixed_matmul_sp_plain(a, w)
            return torch.matmul(dequantize_mixed_device(a),
                                dequantize_mixed_device(w).t())
        return mixed_matmul_sp(a, w)
    if not isinstance(w, ScaledW8):
        raise TypeError(f"no GEMM for weights of type {type(w).__name__}")
    if isinstance(a, MixedTensor):
        # the codes decode in their own segments' device order, which is
        # the weight's column order only for equal budgets
        if a.segments() != w.segments():
            raise ValueError(f"activation segments {a.segments()} vs "
                             f"weight {w.segments()}")
        a = dequantize_mixed_device(a)
    if a.shape[0] >= W8_PREFILL_DEQUANT_THRESHOLD:
        if not a.is_cuda:
            return mixed_matmul_w8_plain(a, w)
        return torch.matmul(a, dequantize_scaled_w8(w, torch.bfloat16).t())
    return mixed_matmul_w8(a, w)


def mixed_matmul_w8_site(x: torch.Tensor, w: ScaledW8, *,
                         producer: str = "plain",
                         gamma: Optional[torch.Tensor] = None,
                         up: Optional[torch.Tensor] = None,
                         perm: Optional[torch.Tensor] = None,
                         eps: float = 1e-6, emit_qx: bool = False):
    """Y = fakequant_site(x) . dq(W)^T; with ``emit_qx`` also the site's
    bf16 image for sibling consumers.  ``x``, ``gamma`` and ``perm`` as in
    ``fakequant_site`` (x in source order, gathered by ``perm``)."""
    qx = fakequant_site(x, *w.segments(), producer=producer, gamma=gamma,
                        up=up, perm=perm, eps=eps)
    y = mixed_matmul(qx, w)
    return (y, qx) if emit_qx else y


# ---------------------------------------------------------------- stack


def w8_stack_gemm_plain(qx: torch.Tensor, st: ScaledW8Stack) -> List[torch.Tensor]:
    """[qx . dq(W_i)^T in f32, rounded to bf16] for every section."""
    return [mixed_matmul_w8_plain(qx, section_weight(st, i))
            for i in range(st.n_sections)]


def w8_stack_gemm(qx: torch.Tensor, st: ScaledW8Stack) -> List[torch.Tensor]:
    """The stacked GEMM: the site image qx (M, K) bf16 against every
    section of ``st`` in one launch -> [(M, N_i) bf16]."""
    m, k = qx.shape
    if st.k != k:
        raise ValueError(f"K mismatch: activation {k}, stack {st.k}")
    if not qx.is_cuda:
        return w8_stack_gemm_plain(qx, st)
    _check_gemm_operands("w8_stack", qx, st.codes)
    n_sec = st.n_sections
    if (n_sec > _MAX_SECTIONS or any(p % _BN for p in st.padded)
            or any(n % 8 for n in st.sections)):
        raise ValueError(f"w8_stack takes at most {_MAX_SECTIONS} sections of "
                         f"N % 8 == 0 padded to multiples of {_BN}: "
                         f"{st.sections} / {st.padded}")
    qx = qx.contiguous()
    build.require_cuda("w8_stack", qx, st.codes)
    outs = [torch.empty((m, n), dtype=torch.bfloat16, device=qx.device)
            for n in st.sections]
    if m == 0:
        return outs
    total = sum(st.padded)
    # B's split of the stack taken as one (M, total) weight: F owes B's
    # bits nothing, and its wide tiles number about as many
    splits = w8_gemm_split(m, total, k)
    partial = _partials(splits, m, total, qx.device)
    tiles = wide_tiles(st.sections)
    lib = build.library("w8_stack", _SIG_STACK)
    build.launches["w8_stack"] += 1
    rc = lib.w8_stack(
        build.ptr(qx), build.ptr(st.codes), build.ptr(partial),
        (ctypes.c_int * n_sec)(*st.sections), (ctypes.c_int * n_sec)(*st.padded),
        (ctypes.c_int * (n_sec + 1))(*tiles),
        (ctypes.c_float * n_sec)(*[2.0 ** (b + 126) for b in st.bases]),
        (ctypes.c_void_p * n_sec)(*[o.data_ptr() for o in outs]),
        n_sec, m, k, splits, build.stream())
    build.check(rc, "w8_stack")
    return outs


def _check_stack_site(producer: str) -> None:
    if producer not in ("plain", "rms"):
        raise ValueError(f"a stacked site is plain or rms, got {producer!r}")


def mixed_matmul_w8_stack_plain(x, st, *, producer="plain", gamma=None,
                                perm=None, eps=1e-6) -> List[torch.Tensor]:
    _check_stack_site(producer)
    qx = fakequant_site_plain(x, *st.segments(), producer=producer,
                              gamma=gamma, perm=perm, eps=eps)
    return w8_stack_gemm_plain(qx, st)


def mixed_matmul_w8_stack(x: torch.Tensor, st: ScaledW8Stack, *,
                          producer: str = "plain",
                          gamma: Optional[torch.Tensor] = None,
                          perm: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> List[torch.Tensor]:
    """[Y_i = fakequant_site(x) . dq(W_i)^T for the sections of ``st``].

    ``x``, ``gamma`` and ``perm`` as in ``fakequant_site`` (producer
    "plain" or "rms").  Biases are not applied: ``project_all`` adds them.
    Two launches on the GPU: the site kernel, then the stacked GEMM.
    """
    _check_stack_site(producer)
    qx = fakequant_site(x, *st.segments(), producer=producer, gamma=gamma,
                        perm=perm, eps=eps)
    return w8_stack_gemm(qx, st)


# ----------------------------------------------------------------- pair

# Rows up to which Kernel G runs its decode-row strip (csrc/w8_rows.cuh:
# the weights on the MMA's 16-row side); above, w8_tile.cuh's tile.  Both
# are one launch.  Set from the card's timings of both at 8-128 rows
# (chip_smoke.py phase 2, "G routes"; PERF.md).
W8_RESIDUAL_ROWS_MAX_M = 32
_ROWS_STRIP = 32        # csrc/w8_rows.cuh: weight rows a block
_ROWS_MAX_M = 32        # token rows it takes (4 n8 tiles)
_ROWS_WARPS = 8         # its warps, which split a block's share of K
# a K split only where the strips alone are fewer blocks than this (one
# block an SM; N = 4096 is 128 strips)
_ROWS_MIN_BLOCKS = 128
# per device and stream: the tickets (zero between launches) and f32
# partials of Kernel G's K split
_residual_scratch: dict = {}


def residual_route(m: int) -> str:
    """Kernel G's mainloop at ``m`` token rows: "rows" (the decode-row
    strip) up to ``W8_RESIDUAL_ROWS_MAX_M``, "tile" above."""
    return "rows" if m <= W8_RESIDUAL_ROWS_MAX_M else "tile"


def residual_plan(m: int, n: int, k: int, route: str) -> Tuple[int, int]:
    """(blocks a split, K splits) of Kernel G on ``route``.  "rows": one
    32-row strip a block, split only where the strips number fewer than
    ``_ROWS_MIN_BLOCKS`` (the smallest divisor of the 128-deep K steps, at
    most 16, that gets there while each warp keeps a 128-deep step, else
    the largest that does); "tile": ``split_k``'s split.  Each split's
    last block (by ticket) sums the partials, so the blocks a split are
    also the tickets."""
    if route == "tile":
        return -(-n // _BN) * -(-m // (16 if m <= 16 else 64)), split_k(m, n, k)
    if route != "rows" or m > _ROWS_MAX_M:
        raise ValueError(f"no G route {route!r} at {m} rows")
    strips, steps = -(-n // _ROWS_STRIP), k // _BK
    ds = [d for d in range(1, min(steps, 16) + 1)
          if steps % d == 0 and (d == 1 or steps // d >= _ROWS_WARPS)]
    return strips, next((d for d in ds if strips * d >= _ROWS_MIN_BLOCKS), ds[-1])


def _residual_buffers(device: torch.device, n_tickets: int,
                      n_partial: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's tickets and partials on this device and stream, grown as
    needed: launches on one stream run in order, so all its calls share
    them, and the sizes depend on shapes only."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    bufs = _residual_scratch.setdefault(key, {})
    for name, size, make in (("tickets", n_tickets, torch.zeros),
                             ("partial", n_partial, torch.empty)):
        if name not in bufs or bufs[name].numel() < size:
            bufs[name] = make(max(size, 1024), dtype=torch.int32 if name == "tickets"
                              else torch.float32, device=device)
    return bufs["tickets"], bufs["partial"]


def w8_residual_plain(qa: torch.Tensor, wa: ScaledW8, h_in: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_in + (qa . dq(Wa)^T (+ bias)) with the unfused chain's bf16
    rounding points: the product, the bias add and the residual add each
    round to bf16."""
    a = mixed_matmul_w8_plain(qa, wa)
    if bias is not None:
        a = a + bias.to(torch.bfloat16)
    return h_in + a


def w8_residual(qa: torch.Tensor, wa: ScaledW8, h_in: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G, the pair's middle stage: h_mid (M, N) bf16 = h_in +
    qa . dq(Wa)^T (+ bias), one launch, on the route ``residual_route``
    picks."""
    return w8_residual_routed(qa, wa, h_in, bias, residual_route(qa.shape[0]))


def w8_residual_routed(qa: torch.Tensor, wa: ScaledW8, h_in: torch.Tensor,
                       bias: Optional[torch.Tensor], route: str) -> torch.Tensor:
    """``w8_residual`` on the given route ("rows" up to 32 rows, or
    "tile")."""
    m, k = qa.shape
    n = wa.rows
    if wa.k != k or h_in.shape != (m, n):
        raise ValueError(f"pair shapes: image {tuple(qa.shape)}, weight "
                         f"({n}, {wa.k}), residual {tuple(h_in.shape)}")
    if not qa.is_cuda:
        return w8_residual_plain(qa, wa, h_in, bias)
    _check_gemm_operands("w8_residual", qa, wa.codes)
    if n % 8 or h_in.dtype != torch.bfloat16:
        raise ValueError("w8_residual needs N % 8 == 0 and a bf16 residual")
    qa, h_in = qa.contiguous(), h_in.contiguous()
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)")
    build.require_cuda("w8_residual", qa, wa.codes, h_in, bias)
    out = torch.empty_like(h_in)
    if m == 0:
        return out
    blocks, splits = residual_plan(m, n, k, route)
    tickets, partial = _residual_buffers(qa.device, blocks,
                                         splits * m * n if splits > 1 else 0)
    lib = build.library("w8_pair", _SIG_PAIR)
    fn = lib.w8_residual_rows if route == "rows" else lib.w8_residual_tile
    build.launches["w8_pair"] += 1
    rc = fn(build.ptr(qa), build.ptr(wa.codes), build.ptr(h_in), build.ptr(bias),
            build.ptr(out), build.ptr(partial), build.ptr(tickets), m, n, k,
            w8_scale(wa), splits, build.stream())
    build.check(rc, "w8_pair")
    return out


def _check_pair(x_a, h_in, wa, stack_b, producer_a):
    if producer_a not in ("plain", "silu"):
        raise ValueError(f"site A is plain or silu, got {producer_a!r}")
    if x_a.shape[1] != wa.k or wa.rows != h_in.shape[1] or stack_b.k != wa.rows:
        raise ValueError(f"pair shapes: x_a {tuple(x_a.shape)}, Wa "
                         f"({wa.rows}, {wa.k}), h_in {tuple(h_in.shape)}, "
                         f"stack K {stack_b.k}")


def mixed_matmul_w8_pair_plain(x_a, h_in, wa, stack_b, *, gamma_b,
                               producer_a="plain", up_a=None, perm_a=None,
                               bias_a=None, perm_b=None, eps=1e-6):
    _check_pair(x_a, h_in, wa, stack_b, producer_a)
    qa = fakequant_site_plain(x_a, *wa.segments(), producer=producer_a,
                              up=up_a, perm=perm_a, eps=eps)
    h_mid = w8_residual_plain(qa, wa, h_in, bias_a)
    return h_mid, mixed_matmul_w8_stack_plain(
        h_mid, stack_b, producer="rms", gamma=gamma_b, perm=perm_b, eps=eps)


def mixed_matmul_w8_pair(x_a: torch.Tensor, h_in: torch.Tensor, wa: ScaledW8,
                         stack_b: ScaledW8Stack, *, gamma_b: torch.Tensor,
                         producer_a: str = "plain",
                         up_a: Optional[torch.Tensor] = None,
                         perm_a: Optional[torch.Tensor] = None,
                         bias_a: Optional[torch.Tensor] = None,
                         perm_b: Optional[torch.Tensor] = None,
                         eps: float = 1e-6):
    """(h_mid, [Y_b...]), the residual pair:

        A     = site_a(x_a[, up_a]) . dq(Wa)^T          (o or down proj)
        h_mid = h_in + A (+ bias_a)                      (residual close)
        Y_b   = fq(rms(h_mid) * gamma_b) . dq(W_b,i)^T   (stack_b sections)

    ``x_a`` in source order, gathered by ``perm_a`` (plain site) or the
    silu site's gate with ``up_a``; ``gamma_b`` (K,) in source order,
    ``perm_b`` the rms site's gather.  h_mid rounds exactly where the
    unfused chain rounds.  Four launches on the GPU: site A, the GEMM that
    closes the residual, site B, the stacked GEMM.
    """
    _check_pair(x_a, h_in, wa, stack_b, producer_a)
    qa = fakequant_site(x_a, *wa.segments(), producer=producer_a, up=up_a,
                        perm=perm_a, eps=eps)
    h_mid = w8_residual(qa, wa, h_in, bias_a)
    return h_mid, mixed_matmul_w8_stack(h_mid, stack_b, producer="rms",
                                        gamma=gamma_b, perm=perm_b, eps=eps)


# -------------------------------------------------------------- grouped


def w8_grouped_gemm_plain(qx: torch.Tensor, gw: GroupedW8) -> List[torch.Tensor]:
    """[(E, C, N_i)]: every group's image rows against its own sections,
    each product in f32 rounded to bf16 (the per-expert loop's values)."""
    return [torch.stack([mixed_matmul_w8_plain(qx[e], grouped_section(gw, e, i))
                         for e in range(gw.groups)])
            for i in range(gw.n_sections)]


def w8_grouped_gemm(qx: torch.Tensor, gw: GroupedW8) -> List[torch.Tensor]:
    """The grouped GEMM: the site image qx (E, C, K) bf16, group e's rows
    against group e's sections of ``gw``, in one launch ->
    [(E, C, N_i) bf16].  Bit for bit the per-group loop of Kernel B."""
    e, c, k = qx.shape
    if gw.k != k or gw.groups != e:
        raise ValueError(f"grouped shapes: image {tuple(qx.shape)}, weights "
                         f"{tuple(gw.codes.shape)}")
    if not qx.is_cuda:
        return w8_grouped_gemm_plain(qx, gw)
    _check_gemm_operands("w8_grouped", qx.reshape(-1, k), gw.codes)
    n_sec = gw.n_sections
    if (n_sec > _MAX_SECTIONS or e > _MAX_GROUPS
            or any(p % _BN for p in gw.padded) or any(n % 8 for n in gw.sections)):
        raise ValueError(f"w8_grouped takes at most {_MAX_GROUPS} groups and "
                         f"{_MAX_SECTIONS} sections of N % 8 == 0 padded to "
                         f"multiples of {_BN}: {e}, {gw.sections} / {gw.padded}")
    build.require_cuda("w8_grouped", qx, gw.codes)
    outs = [torch.empty((e, c, n), dtype=torch.bfloat16, device=qx.device)
            for n in gw.sections]
    if c == 0:
        return outs
    total = sum(gw.padded)
    # Kernel B's split for one group's first section: the same f32 sums
    splits = w8_gemm_split(c, gw.sections[0], k)
    partial = (torch.empty((splits, e, c, total), dtype=torch.float32,
                           device=qx.device) if splits > 1 else None)
    scales = [2.0 ** (b + 126) for row in gw.bases for b in row]
    tiles = wide_tiles(gw.sections)
    lib = build.library("w8_grouped", _SIG_GROUPED)
    build.launches["w8_grouped"] += 1
    rc = lib.w8_grouped(
        build.ptr(qx), build.ptr(gw.codes), build.ptr(partial),
        (ctypes.c_int * n_sec)(*gw.sections), (ctypes.c_int * n_sec)(*gw.padded),
        (ctypes.c_int * (n_sec + 1))(*tiles),
        (ctypes.c_float * len(scales))(*scales),
        (ctypes.c_void_p * n_sec)(*[o.data_ptr() for o in outs]),
        n_sec, e, c, k, splits, build.stream())
    build.check(rc, "w8_grouped")
    return outs


def _grouped_site(x, gw, producer, up, perm, eps, site):
    """The grouped call's site: all E x C rows, each group with its own
    ``perm`` row (plain) or its own ``up`` rows (silu) -> (E, C, K)."""
    if producer not in ("plain", "silu"):
        raise ValueError(f"a grouped site is plain or silu, got {producer!r}")
    e, c, k = x.shape
    if gw.groups != e or gw.k != k:
        raise ValueError(f"grouped shapes: x {tuple(x.shape)}, weights "
                         f"{tuple(gw.codes.shape)}")
    for name, t in (("x", x), ("up", up)):
        if t is not None and x.is_cuda and (
                not t.is_contiguous() or t.dtype != torch.bfloat16):
            raise ValueError(f"w8_grouped: {name} must be contiguous bf16")
    kw = dict(producer=producer, eps=eps)
    if producer == "silu":
        if up is None or up.shape != x.shape:
            raise ValueError("the silu site needs up of x's shape")
        kw["up"] = up.reshape(-1, k)
    elif perm is not None:
        if perm.shape != (e, k):
            raise ValueError(f"perm shape {tuple(perm.shape)} != ({e}, {k})")
        kw["perm"] = perm
    img = site(x.reshape(-1, k), *gw.segments(), **kw)
    return img.reshape(e, c, k)


def mixed_matmul_w8_grouped_plain(x, gw, *, producer="plain", up=None,
                                  perm=None, eps=1e-6) -> List[torch.Tensor]:
    qx = _grouped_site(x, gw, producer, up, perm, eps, fakequant_site_plain)
    return w8_grouped_gemm_plain(qx, gw)


def mixed_matmul_w8_grouped(x: torch.Tensor, gw: GroupedW8, *,
                            producer: str = "plain",
                            up: Optional[torch.Tensor] = None,
                            perm: Optional[torch.Tensor] = None,
                            eps: float = 1e-6) -> List[torch.Tensor]:
    """[Y_i[e] = site(x[e]) . dq(W_i[e])^T for every group e], the MoE
    experts' grouped GEMM.

    x: (E, C, K) per-group pre-site activations in source order; ``gw``
    a GroupedW8; producer "plain" with ``perm`` (E, K) int32, each group's
    own gather, or "silu" (x = gate, ``up`` (E, C, K)).  Returns
    [(E, C, N_i) bf16] per section, biases not applied.  Two launches on
    the GPU: the site kernel over all E x C rows, then the grouped GEMM;
    bit for bit the per-group loop of ``mixed_matmul_w8_site`` there.
    """
    qx = _grouped_site(x, gw, producer, up, perm, eps, fakequant_site)
    return w8_grouped_gemm(qx, gw)


# ---------------------------------------------------------- split-plane

# From this M on, a split-plane product dequantizes both operands and
# multiplies them in one dense product (the JAX package's
# PREFILL_DEQUANT_THRESHOLD, not the ScaledW8 one); below, Kernel K.
PREFILL_DEQUANT_THRESHOLD = 512
# the widest weight strip of the split-plane tile (csrc/sp_tile.cuh, at
# 128 rows); stacks pad their sections to multiples of it
_SP_STRIP = 128

_MX_FIELDS = ("fp4", "fp6", "fp8", "sf4", "sf6", "sf8")
_SIG_SP = {"sp_gemm": [build.PTRS, build.PTRS, build.PTR, build.PTR, build.PTR]
           + [build.INT] * 7 + [build.PTR]}
_SIG_SP_STACK = {"sp_stack": [build.PTR, build.PTRS, build.PTR, build.INTS,
                              build.INTS, build.PTRS] + [build.INT] * 7
                 + [build.PTR]}


def sp_split_k(m: int, k: int) -> int:
    """K splits of the split-plane GEMMs: the fewest that leave each split
    at most 8 (M <= 16), 32 (M <= 64), 16 (M <= 128: a single 128-row
    tile, whose blocks have an SM each, so K is split further to fill the
    card) or 64 (above) steps of 128 columns.  A function of M and K only,
    so Kernels K and L, given the same M and K, sum every output element
    in the same order."""
    steps = k // _BK
    most = 8 if m <= 16 else 32 if m <= 64 else 16 if m <= 128 else 64
    return next(d for d in range(1, steps + 1)
                if steps % d == 0 and steps // d <= most)


def _mx_ptrs(t: MixedTensor):
    return (ctypes.c_void_p * 6)(*[build.ptr(getattr(t, f)) for f in _MX_FIELDS])


def _check_sp_weight(name: str, w: MixedTensor, k: int) -> None:
    if w.k != k:
        raise ValueError(f"K mismatch: activation {k}, weight {w.k}")
    if any(s % _BK for s in w.segments()) or (w.segments()[0] and not w.fp4_packed):
        raise ValueError(f"{name} takes segments of multiples of {_BK} "
                         f"columns, fp4 packed: {w.segments()}")


def _require_mx(name: str, a: Optional[MixedTensor], w: MixedTensor) -> None:
    """Codes on one CUDA device, contiguous and 16-byte aligned (loaded 16
    bytes at a time), and so are the weight's scale bytes (staged 16 bytes
    at a time); the activation's scale bytes on it and contiguous."""
    ts = [t for t in (a, w) if t is not None]
    build.require_cuda(name, *[getattr(t, f) for t in ts for f in _MX_FIELDS[:3]],
                       w.sf4, w.sf6, w.sf8)
    if a is not None:
        for sf in (a.sf4, a.sf6, a.sf8):
            if sf.device != a.fp4.device or not sf.is_contiguous():
                raise ValueError(f"{name}: scales on {sf.device} or "
                                 "non-contiguous")


def mixed_matmul_sp_plain(a: MixedTensor, w: MixedTensor) -> torch.Tensor:
    """dq(A) . dq(W)^T in f32, rounded to bf16 (the kernel's function)."""
    return torch.matmul(dequantize_mixed_device(a, torch.float32),
                        dequantize_mixed_device(w, torch.float32).t()
                        ).to(torch.bfloat16)


def mixed_matmul_sp(a: MixedTensor, w: MixedTensor) -> torch.Tensor:
    """Kernel K: Y (M, N) bf16 = dq(A codes) . dq(W)^T, f32 accumulation.
    ``a``: activation codes (fp4 unpacked, ``kernels.quantize``); ``w``:
    a split-plane weight, fp4 packed, FP4 or FP6/FP8 codes in the fp6 and
    fp8 segments (``fp4_only``)."""
    if a.segments() != w.segments() or a.fp4_packed:
        raise ValueError(f"activation segments {a.segments()} (packed "
                         f"{a.fp4_packed}) vs weight {w.segments()}")
    if not a.fp4.is_cuda:
        return mixed_matmul_sp_plain(a, w)
    m, n, k = a.rows, w.rows, a.k
    _check_sp_weight("sp_gemm", w, k)
    if n % 8:
        raise ValueError(f"sp_gemm needs N % 8 == 0, got {n}")
    _require_mx("sp_gemm", a, w)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.fp4.device)
    if m == 0:
        return out
    splits = sp_split_k(m, k)
    partial = _partials(splits, m, n, out.device)
    image = torch.empty((m, k), dtype=torch.bfloat16, device=out.device)
    lib = build.library("sp_gemm", _SIG_SP)
    build.launches["sp_gemm"] += 1
    rc = lib.sp_gemm(_mx_ptrs(a), _mx_ptrs(w), build.ptr(image), build.ptr(out),
                     build.ptr(partial), m, n, *w.segments(),
                     int(w.fp4_only), splits, build.stream())
    build.check(rc, "sp_gemm")
    return out


def sp_stack_gemm_plain(qx: torch.Tensor, st: SplitPlaneStack) -> List[torch.Tensor]:
    """[qx . dq(W_i)^T in f32, rounded to bf16] for every section."""
    qf = qx.to(torch.float32)
    return [torch.matmul(qf, dequantize_mixed_device(
        section_mixed(st, i), torch.float32).t()).to(torch.bfloat16)
        for i in range(st.n_sections)]


def sp_stack_gemm(qx: torch.Tensor, st: SplitPlaneStack) -> List[torch.Tensor]:
    """Kernel L: the site image qx (M, K) bf16 against every section of
    ``st`` in one launch -> [(M, N_i) bf16]; each section's output equals
    Kernel K's on the codes qx encodes, bit for bit."""
    m, k = qx.shape
    if not qx.is_cuda:
        if st.k != k:
            raise ValueError(f"K mismatch: activation {k}, stack {st.k}")
        return sp_stack_gemm_plain(qx, st)
    _check_sp_weight("sp_stack", st.mt, k)
    n_sec = st.n_sections
    if (qx.dtype != torch.bfloat16 or n_sec > _MAX_SECTIONS
            or any(p % _SP_STRIP for p in st.padded)
            or any(n % 8 for n in st.sections)):
        raise ValueError(f"sp_stack takes a bf16 image and at most "
                         f"{_MAX_SECTIONS} sections of N % 8 == 0 padded to "
                         f"multiples of {_SP_STRIP}: {st.sections} / {st.padded}")
    qx = qx.contiguous()
    build.require_cuda("sp_stack", qx)
    _require_mx("sp_stack", None, st.mt)
    outs = [torch.empty((m, n), dtype=torch.bfloat16, device=qx.device)
            for n in st.sections]
    if m == 0:
        return outs
    total = sum(st.padded)
    splits = sp_split_k(m, k)
    partial = _partials(splits, m, total, qx.device)
    lib = build.library("sp_stack", _SIG_SP_STACK)
    build.launches["sp_stack"] += 1
    rc = lib.sp_stack(
        build.ptr(qx), _mx_ptrs(st.mt), build.ptr(partial),
        (ctypes.c_int * n_sec)(*st.sections), (ctypes.c_int * n_sec)(*st.padded),
        (ctypes.c_void_p * n_sec)(*[o.data_ptr() for o in outs]),
        n_sec, m, *st.segments(), int(st.mt.fp4_only), splits, build.stream())
    build.check(rc, "sp_stack")
    return outs


def _sp_site_kw(producer, gamma, up, perm, eps) -> dict:
    if producer not in ("plain", "rms", "silu"):
        raise ValueError(f"a split-plane site is plain, rms or silu, got {producer!r}")
    return dict(producer=producer, gamma=gamma, up=up, perm=perm, eps=eps)


def mixed_matmul_sp_stack_plain(x, st, *, producer="plain", gamma=None,
                                up=None, perm=None, eps=1e-6) -> List[torch.Tensor]:
    qx = fakequant_site_plain(x, *st.segments(),
                              **_sp_site_kw(producer, gamma, up, perm, eps))
    return sp_stack_gemm_plain(qx, st)


def mixed_matmul_sp_stack(x: torch.Tensor, st: SplitPlaneStack, *,
                          producer: str = "plain",
                          gamma: Optional[torch.Tensor] = None,
                          up: Optional[torch.Tensor] = None,
                          perm: Optional[torch.Tensor] = None,
                          eps: float = 1e-6) -> List[torch.Tensor]:
    """[Y_i = fakequant_site(x) . dq(W_i)^T for the sections of ``st``].

    ``x``, ``gamma``, ``up`` and ``perm`` as in ``fakequant_site``
    (producer "plain", "rms" or "silu").  Biases are not applied.  Two
    launches on the GPU: the site kernel (Kernel A), then Kernel L.  Equal
    to the activation quantize (Kernel J) followed by Kernel K on each
    section, bit for bit: the site image is the exact decode of J's codes.
    """
    qx = fakequant_site(x, *st.segments(),
                        **_sp_site_kw(producer, gamma, up, perm, eps))
    return sp_stack_gemm(qx, st)
