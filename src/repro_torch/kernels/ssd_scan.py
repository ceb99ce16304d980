"""Mamba-2 SSD chunked scan: the plain version and the kernel.

``cs_ssd_scan`` (``csrc/ssd_scan.cuh``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_pallas`` (``_ssd_kernel``).  The
Pallas grid walks the chunk axis in order and carries the (P, N) state
in VMEM; on the card a thread block loops over the chunks itself and
owns ``SLICE`` rows p of one (batch row, head)'s state, which stays on
chip throughout (grid: P slices x heads x batch rows).

Both take the time axis in chunks of ``q = min(chunk, L)`` when L is not
a multiple of ``chunk`` (else ``chunk``); a q past ``Q_MAX`` (one scan
step per thread) runs as consecutive sub-chunks of at most ``Q_MAX``
steps (``scan_chunk``), which equals the chunked scan in exact
arithmetic.  The plain version pads L to a multiple of q with identity
steps (log_a = 0 keeps the state, x = b = 0 adds nothing), as the JAX
package's ``ops.ssd_scan`` does; the kernel masks the ragged last chunk
instead, which is the same arithmetic.

Operands (``operand_mode``): bf16 x, b and c in the layout the serving
and training paths give them are read in place (``FAST``).  Every other
operand the reference's scan takes (f32 or f16 data, ragged P or N,
strided or misaligned rows) is first copied by a staging kernel
(``csrc/ssd_scan_staged.cu``) into a packed, zero-padded scratch on the
next build width as bf16 hi and lo halves (``SPLIT``), which keep
about 16 bits of f32 data through the tensor-core products (a bf16
value's lo half is 0; an f16 value is exactly its two halves).  A bf16,
f16 or strided log_a is widened to packed f32 the same way.  y, the
state and the gradients come out in the caller's dtypes (f16 ones
written by the kernels in f16).

State widths past ``N_SLAB`` run on the slabbed build, every multiple of
``N_SLAB`` as ``column_slabs(N)`` column slabs of ``N_SLAB`` over blocks
(the slab count a grid dimension), each the N-128 body: the forward and
the backward's chunk-parallel kernels write the terms that sum over N
(y, dX, dlog_a) as f32 partials per slab, added in a fixed order.  Any
other N past ``N_SLAB`` runs staged on the next multiple of it.

Bound on an H100: bytes.  The kernel runs every product on the tensor
cores (``mma.sync`` bf16 -> f32; the f32 operands M = (C B^T) o decay,
the state and w o B enter as bf16 hi + lo, about 16 bits), so the f32
state's read and write and the x/b/c/y rows take longer than the
function's flops at 989 TFLOP/s; ``ssd_scan_work`` counts both.

The backward, ``cs_ssd_scan_bwd`` (same source), has no TPU
counterpart: the reference trains through its plain scan, which
``jax.grad`` differentiates.  Under grad the forward kernel also writes
the state entering each chunk (``states``, (B, H, nc, P, N) f32).  Only
the state's gradient dS is carried from chunk to chunk, so the backward
is three launches: (a) each chunk's (e o dY)^T C, chunk-parallel
(``ssd_bwd_chunk_plain``); (b) the one sequential pass, which turns
those into the dS leaving each chunk (``ssd_bwd_state_plain``); (c) the
rest, chunk-parallel on the tensor cores (``ssd_bwd_local_plain``);
then the fixed-order sums over a group's heads.  ``ssd_scan_bwd_staged``
composes the three plain stages, ``bwd_launch_geometry`` mirrors the
launches and their scratch.  ``SsdScanFn`` is the ``autograd.Function``
over a (forward, backward) pair: the kernels on the card, the plain
versions (``ssd_scan_fwd_plain``, ``ssd_scan_bwd_plain``) in the tests.
"""
from __future__ import annotations

import ctypes

import torch

from . import contracts, cuda
from .ref import ssd_chunked_scan_grouped_ref

NAME = "ssd_scan"
BWD_NAME = "ssd_scan_bwd"
Q_MAX = 256           # the kernel's largest chunk (one scan step per thread)
SLICE = 32            # state rows p per thread block
THREADS = 256
# the state widths one block's builds hold (jamba; the JAX benchmarks'
# audit row; mamba2); any other N up to the last runs on the next one up,
# and past it every multiple of N_SLAB runs on the slabbed build (Mamba-2's
# state expansion: 256, 512), any other N on the next multiple
STATE_WIDTHS = (16, 32, 64, 128)
N_SLAB = 128          # the widest state slab one block holds; wider builds run N / N_SLAB
SMEM_LIMIT = 232_448  # shared bytes one block may use on an H100 (227 KB)
BWD_SLAB = 64         # P columns per block of the backward's chunk-parallel kernels
BWD_HEADS = 2         # heads per block of its chunk-local kernel, where a group's count is even
SPLIT_SLAB = 32       # P columns per chunk-local block on hi / lo operands (16 at slab N 128)
FAST, SPLIT = 0, 1    # operand modes (csrc/ssd_scan.cuh)
_OUT_F32, _OUT_BC_F32, _OUT_LA_BF16 = 1, 2, 4
_OUT_F16, _OUT_BC_F16, _OUT_LA_F16 = 8, 16, 32
# cs_ssd_stage's source types
_SRC_TYPE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def scan_chunk(L: int, chunk: int) -> int:
    """The chunk the kernel runs: ``q = chunk``, or ``min(chunk, L)`` when
    L is not a multiple of it; a q past ``Q_MAX`` as ceil(q / Q_MAX)
    equal sub-chunks (rounded up), each at most ``Q_MAX`` steps."""
    q = min(chunk, L) if L % chunk else chunk
    return -(-q // -(-q // Q_MAX))


# the build each state width 1..N_SLAB runs on (index N)
_BUILD_OF = (0,) + tuple(next(w for w in STATE_WIDTHS if w >= n)
                         for n in range(1, N_SLAB + 1))


def build_width(N: int) -> int:
    """The build a state width N runs on (its columns past N zero): the
    smallest of ``STATE_WIDTHS`` that holds it, or past ``N_SLAB`` the
    next multiple of ``N_SLAB``."""
    return _BUILD_OF[N] if N <= N_SLAB else -(-N // N_SLAB) * N_SLAB


def column_slabs(N: int) -> int:
    """The column slabs of ``N_SLAB`` a build of width N runs over blocks
    (1 up to ``N_SLAB``)."""
    return N // N_SLAB if N > N_SLAB else 1


def operand_mode(x, b, c, dy=None) -> int:
    """``FAST`` where bf16 x, b and c (and dy) are read in place: N a
    build, P a multiple of 8, heads, groups and features packed with c at
    b's strides, rows on 16-byte boundaries; else ``SPLIT``."""
    bf = torch.bfloat16
    if x.dtype != bf or b.dtype != bf or c.dtype != bf or (dy is not None and dy.dtype != bf):
        return SPLIT
    P, N = x.shape[3], b.shape[3]
    xs, bs = x.stride(), b.stride()
    fast = (build_width(N) == N and P % 8 == 0 and xs[3] == 1 and xs[2] == P
            and bs[3] == 1 and bs[2] == N and c.stride() == bs
            and (xs[0] | xs[1] | bs[0] | bs[1]) % 8 == 0
            and (x.data_ptr() | b.data_ptr() | c.data_ptr()) % 16 == 0)
    return FAST if fast else SPLIT


def chunk_count(L: int, chunk: int) -> int:
    """The number of chunks the scan runs, the last one maybe ragged."""
    return -(-L // scan_chunk(L, chunk))


def launch_geometry(B: int, H: int, P: int, N: int, q: int, mode: int = FAST):
    """(grid, threads, shared bytes) of the kernel for chunk q on build
    width N, as ``csrc/ssd_scan.cuh`` lays them out (``SsdSmem``): rows =
    q rounded up to 16; B rows (rows x n bf16, sharing their bytes with
    the f32 state slice), the x slice (rows x SLICE bf16), the state's
    bf16 hi and lo halves, cum and the scan partials; row strides padded
    by 16 bytes; n the slab width (N, or ``N_SLAB`` past it, the grid's P
    slices then times ``column_slabs(N)``).  ``SPLIT`` holds the B rows
    and the x slice twice (hi, lo)."""
    rows = -(-q // 16) * 16
    ns = column_slabs(N)
    ld = N // ns + 8
    k = 2 if mode == SPLIT else 1
    smem = (max(k * 2 * rows * ld, 4 * SLICE * ld) + k * 2 * rows * (SLICE + 8)
            + 2 * 2 * SLICE * ld + 4 * rows + 4 * (THREADS // 32))
    return (-(-P // SLICE) * ns, H, B), THREADS, smem


def staged_bytes(B: int, L: int, H: int, P: int, G: int, N: int, mode: int,
                 x_bytes: int = 2, bc_bytes: int = 2, backward: bool = False) -> int:
    """Bytes the staging pass moves before the kernel (0 in ``FAST``):
    x, b and c (and dY in the backward) read once in the caller's dtype
    and written once as bf16 hi and lo halves on the padded widths."""
    if mode == FAST:
        return 0
    Pp, Nb = -(-P // 8) * 8, build_width(N)
    xs = (2 if backward else 1) * B * L * H * (P * x_bytes + 2 * 2 * Pp)
    return xs + 2 * B * L * G * (N * bc_bytes + 2 * 2 * Nb)


def bwd_heads(H: int, G: int, mode: int = FAST) -> int:
    """Heads per block of the backward's chunk-local kernel: a pair of
    one group's heads where the group's head count is even, else one
    (always one in ``SPLIT``)."""
    return BWD_HEADS if mode == FAST and (H // G) % 2 == 0 else 1


def bwd_launch_geometry(B: int, L: int, H: int, P: int, G: int, N: int, chunk: int,
                        mode: int = FAST, la_bf16: bool = False):
    """The backward's launches on build width N, {name: (grid, threads,
    shared bytes)}, and its f32 scratch in bytes, as
    ``csrc/ssd_scan.cuh:launch_bwd`` lays them out (rows = q rounded up to
    16, row pitches padded by 16 bytes; ``SPLIT`` holds every bf16 row
    array twice, hi and lo, and its chunk-local kernel takes P slabs of
    ``SPLIT_SLAB`` columns, 16 at N 128, and one head):

    * ``chunk`` (a): C rows (rows x N bf16), a slab of dY rows (rows x
      BWD_SLAB bf16), e and the scan partials (``ChunkSmem``);
    * ``state`` (b): four f32 elements of a (b, h)'s P x N per thread;
    * ``local`` (c): B or C rows, x or dY rows of BWD_HEADS heads, the
      states' bf16 hi and lo halves of BWD_HEADS heads, cum, dcum and
      the w terms of each head, scan and reduction partials
      (``BwdSmem``);
    * ``sum``: dB and dC summed over a group's head blocks and P slabs.

    Past ``N_SLAB`` (a) and (c) run on ``column_slabs(N)`` column slabs
    of ``N_SLAB`` over blocks, at that width's shared bytes.

    Scratch: ``states`` the dS leaving each chunk (B, H, nc, P, N),
    ``cum`` cum_q (B, H, nc, rounded up to 4 elements), ``partials`` the
    dB and dC partials (B, L, H / hb, nps, N) each, ``dx`` dX's partials
    per column slab (B, L, H, ns, P) past one slab, ``lpart`` dlog_a's
    per P and column slab (B, L, H, nps x ns) when there is more than one
    slab or dlog_a is 16-bit, bf16 or f16 (``la_bf16``)."""
    q, nc = scan_chunk(L, chunk), chunk_count(L, chunk)
    rows = -(-q // 16) * 16
    ns = column_slabs(N)
    n = N // ns                       # the width one block holds
    k, slab = ((2, SPLIT_SLAB if n < 128 else 16) if mode == SPLIT else (1, BWD_SLAB))
    hmax = BWD_HEADS if mode == FAST else 1
    nps_a, nps = -(-P // BWD_SLAB), -(-P // slab)
    hb, warps = bwd_heads(H, G, mode), THREADS // 32
    ldn, ldp = n + 8, slab + 8
    chunk_smem = k * 2 * rows * ldn + k * 2 * rows * (BWD_SLAB + 8) + 4 * rows + 4 * warps
    local_smem = (k * 2 * rows * ldn + k * 2 * hmax * rows * ldp + 2 * hmax * 2 * slab * ldn
                  + 3 * 4 * hmax * rows + 4 * 2 * hmax * warps)
    launches = {
        "chunk": ((nc * nps_a * ns, H, B), THREADS, chunk_smem),
        "state": ((-(-P * N // (4 * THREADS)), H, B), THREADS, 0),
        "local": ((nc * nps * ns, H // hb, B), THREADS, local_smem),
        "sum": ((-(-B * L * G * N // THREADS),), THREADS, 0),
    }
    scratch = {
        "states": 4 * B * H * nc * P * N,
        "cum": 4 * (-(-B * H * nc // 4) * 4),
        "partials": 2 * 4 * B * L * (H // hb) * nps * N,
        "dx": 4 * B * L * H * ns * P if ns > 1 else 0,
        "lpart": 4 * B * L * H * nps * ns if nps * ns > 1 or la_bf16 else 0,
    }
    return launches, scratch


def ssd_scan_plain(x, log_a, b, c, init_state=None, chunk: int = 128, states: bool = False):
    """x (B, L, H, P); log_a (B, L, H); b, c (B, L, G, N) per group;
    init_state (B, H, P, N) or None.  Returns y (B, L, H, P) in x's
    dtype and the final state (B, H, P, N) f32; with ``states`` also the
    state entering each chunk, (B, H, nc, P, N) f32."""
    L = x.shape[1]
    q = scan_chunk(L, chunk)
    pad = (-L) % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    y, *rest = ssd_chunked_scan_grouped_ref(x, log_a, b, c, q, init_state, states)
    return (y[:, :L], *rest)


def ssd_scan_cuda(x, log_a, b, c, init_state=None, chunk: int = 128):
    """Launch the kernel.  x (B, L, H, P) and b, c (B, L, G, N) in bf16
    with packed heads, groups and features and rows on 16-byte boundaries
    (any batch and time strides), P a multiple of 8 and N one of
    ``STATE_WIDTHS`` or a multiple of ``N_SLAB`` are read in place; any
    other x, b and c in f32, bf16 or f16, log_a (B, L, H) in f32, bf16 or
    f16 and init_state (B, H, P, N) in any layout and dtype pass through
    the staging kernel first.  Any chunk, any N.  Operands the kernel does
    not take (``contracts.SSD_SCAN``; none of the reference's) raise
    ``KernelIneligibleError``, a ``cuda.KernelError``."""
    contracts.require(contracts.ssd_scan_verdict(x, log_a, b, c, init_state, chunk), NAME)
    return ssd_scan_launch(x, log_a, b, c, init_state, chunk)


def _stage(t, width: int, split: bool):
    """``cs_ssd_stage``: t (d0, d1, d2, d3) f32, bf16 or f16, any strides, into
    a packed (d0, d1, d2, width) copy, columns from d3 on zero: bf16 hi
    and lo halves stacked as (2, d0, d1, d2, width) (``split``), or f32."""
    d0, d1, d2, d3 = t.shape
    shape = (d0, d1, d2, width)
    dst = (torch.empty((2,) + shape, dtype=torch.bfloat16, device=t.device) if split else
           torch.empty(shape, dtype=torch.float32, device=t.device))
    rc = cuda.library().cs_ssd_stage(
        t.data_ptr(), _SRC_TYPE[t.dtype], d0, d1, d2, d3, *t.stride(), dst.data_ptr(),
        width, int(split), d0 * d1 * d2 * width, cuda.stream_handle(t))
    cuda.check(rc, NAME)
    return dst


def _split(t, width: int):
    """A data operand as ``SPLIT`` reads it: (its staged hi halves, the
    lo halves' element offset from them)."""
    s = _stage(t, width, True)
    return s[0], s[0].numel()


def _log_a_f32(log_a):
    """log_a as the kernels read it: f32 with packed heads (a staged
    copy otherwise; widening bf16 is exact)."""
    if log_a.dtype == torch.float32 and log_a.stride(2) == 1:
        return log_a
    return _stage(log_a.unsqueeze(-1), 1, False)[..., 0]


def _state_f32(t, width: int):
    """init_state or the chunk states as the kernels read them: f32,
    contiguous, on a 16-byte boundary, at the build ``width`` (a staged
    copy otherwise); None stays None."""
    if t is None or (t.dtype == torch.float32 and t.is_contiguous()
                     and t.data_ptr() % 16 == 0 and t.shape[-1] == width):
        return t
    lead = t.shape[:-3]
    return _stage(t.reshape((-1,) + t.shape[-3:]), width, False).view(
        *lead, *t.shape[-3:-1], width)


def _out_flags(dtype, f32: int, f16: int) -> int:
    """An output's flag bits: ``f32`` or ``f16`` for that dtype, 0 (bf16)
    otherwise."""
    return f32 if dtype == torch.float32 else f16 if dtype == torch.float16 else 0


def ssd_scan_launch(x, log_a, b, c, init, chunk: int, states: bool = False):
    """The launch alone, for operands the registry took (``ops``): the
    staging pass where the operands need it (``operand_mode``), then the
    kernel.  y comes out in x's dtype, the state (B, H, P, N) in f32.
    With ``states`` the kernel also writes the state entering each chunk,
    (B, H, nc, P, build width) f32, and the call returns (y, final state,
    states).  Past ``N_SLAB`` the kernel writes y's f32 partials per
    column slab into scratch, and their sum in slab order is y."""
    B, L, H, P = x.shape
    G, n = b.shape[2], b.shape[3]
    cuda.require(init is None or tuple(init.shape) == (B, H, P, n), NAME,
                 "init_state must be (B, H, P, N)")
    N, q, lib = build_width(n), scan_chunk(L, chunk), cuda.library()
    if operand_mode(x, b, c) == FAST:
        launch, mode, xv, bv, cv, xp, xlo, blo = lib.cs_ssd_scan, FAST, x, b, c, P, 0, 0
    else:
        launch, mode, xp = lib.cs_ssd_scan_staged, SPLIT, -(-P // 8) * 8
        (xv, xlo), (bv, blo), (cv, _) = _split(x, xp), _split(b, N), _split(c, N)
    xs, bs = xv.stride(), bv.stride()
    la = _log_a_f32(log_a)
    las = la.stride()
    init = _state_f32(init, N)
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    st = torch.empty((B, H, P, n), dtype=torch.float32, device=x.device)
    cst = (torch.empty((B, H, chunk_count(L, chunk), P, N), dtype=torch.float32,
                       device=x.device) if states else None)
    ns = column_slabs(N)
    yp = (torch.empty((B, L, H, ns, P), dtype=torch.float32, device=x.device) if ns > 1
          else None)
    rc = launch(
        xv.data_ptr(), la.data_ptr(), bv.data_ptr(), cv.data_ptr(),
        0 if init is None else init.data_ptr(), y.data_ptr(), st.data_ptr(),
        0 if cst is None else cst.data_ptr(), 0 if yp is None else yp.data_ptr(),
        B, L, H, P, G, N, q, xs[0], xs[1], las[0], las[1], bs[0], bs[1], xp, n, xlo, blo,
        _out_flags(x.dtype, _OUT_F32, _OUT_F16), mode, cuda.stream_handle(x),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return (y, st, cst) if states else (y, st)


def ssd_scan_work(L: int, H: int, P: int, G: int, N: int, chunk: int, B: int = 1,
                  x_bytes: int = 2, bc_bytes: int = 2, la_bytes: int = 4):
    """(flops, bytes) the scan needs: for each (b, h) and chunk of q
    steps, 2 flops per (t, s <= t) pair and feature of c.b and of the
    decayed mix of x, and 4qPN for the state's read-out and update;
    x, log_a, b, c and init read once, y and the state written once, at
    the element sizes given (x and y; b and c; log_a)."""
    q = scan_chunk(L, chunk)
    flops = 0.0
    for t0 in range(0, L, q):
        n = min(q, L - t0)
        flops += n * (n + 1) * (N + P) + 4.0 * n * P * N
    flops *= B * H
    n_bytes = (B * L * (H * P * x_bytes * 2 + H * la_bytes + 2 * G * N * bc_bytes)
               + 2 * B * H * P * N * 4)
    return flops, n_bytes


def ssd_scan_bwd_work(L: int, H: int, P: int, G: int, N: int, chunk: int, B: int = 1,
                      x_bytes: int = 2, bc_bytes: int = 2, la_bytes: int = 4):
    """(flops, bytes) the backward needs: for each (b, h) and chunk of q
    steps, 2 flops per (t, s <= t) pair and feature of C B^T, dY X^T,
    M^T dY, (D o R)^T C and (D o R) B, and 16qPN for the four products
    with the state and its gradient (B dS^T, X dS, dY S_in, (e o dY)^T C);
    x, log_a, b, c, dY, the chunk states and the final state's gradient
    read once, dX, dlog_a, dB, dC and the initial state's gradient
    written once, at the element sizes given (x, dY and dX; b, c, dB and
    dC; log_a and dlog_a)."""
    q = scan_chunk(L, chunk)
    flops = 0.0
    for t0 in range(0, L, q):
        n = min(q, L - t0)
        flops += n * (n + 1) * (3 * N + 2 * P) + 8.0 * n * P * N
    flops *= B * H
    # x, dY, dX; log_a, dlog_a; b, c, dB, dC
    row = 3 * H * P * x_bytes + 2 * H * la_bytes + 4 * G * N * bc_bytes
    n_bytes = B * L * row + (chunk_count(L, chunk) + 2) * B * H * P * N * 4
    return flops, n_bytes


def _padded(t, pad: int):
    """``t`` (B, L, ...) f32, with ``pad`` zero steps after L."""
    t = t.float()
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t


def ssd_scan_fwd_plain(x, log_a, b, c, init_state=None, chunk: int = 128):
    """``ssd_scan_plain``'s (y, final state) and the state entering each
    chunk, (B, H, nc, P, N) f32: the forward of the plain pair."""
    return ssd_scan_plain(x, log_a, b, c, init_state, chunk, states=True)


def ssd_scan_bwd_plain(x, log_a, b, c, states, dy, d_final=None, chunk: int = 128,
                       need_init: bool = True):
    """The scan's gradients, chunk by chunk from the last, in f32 from the
    state entering each chunk (``states`` (B, H, nc, P, N)): with cum the
    cumulative log-decay, D[t,s] = exp(cum_t - cum_s) for s <= t, M = D o
    (C B^T), R = dY X^T, K = M o R, w_s = exp(cum_q - cum_s), e_t =
    exp(cum_t) and dS the gradient of the state leaving the chunk:

        dX     = M^T dY + w o (B dS^T)
        dB     = (D o R)^T C + w o (X dS)        (summed over the group)
        dC     = (D o R) B + e o (dY S_in)        (summed over the group)
        dS_in  = exp(cum_q) dS + (e o dY)^T C
        dcum_t = sum_s K[t,s] - sum_s K[s,t] + e_t (dY_t . S_in C_t)
                 - w_t (dS . X_t^T B_t),
        dcum_q += exp(cum_q) <dS, S_in> + sum_s w_s (dS . X_s^T B_s)

    and dlog_a the reverse cumulative sum of dcum within the chunk.  The
    padding is ``ssd_scan_plain``'s (identity steps).  ``dy`` (B, L, H,
    P) and ``d_final`` (B, H, P, N) or None (zeros) are the cotangents of
    y and of the final state.  Returns (dx in x's dtype, dlog_a in
    log_a's, db and dc in b's and c's, d_init f32 or None)."""
    L = x.shape[1]
    q, nc = scan_chunk(L, chunk), chunk_count(L, chunk)
    X, A, Bm, Cm, dY = _chunked(x, log_a, b, c, dy, chunk)
    dS = _final_cotangent(x, b, d_final)
    after = ~torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dX, dA, dB, dC = (torch.empty(t.shape, dtype=torch.float32, device=x.device)
                      for t in (X, A, Bm, Cm))
    for k in reversed(range(nc)):
        xk, bk, ck, gk = X[:, k], Bm[:, k], Cm[:, k], dY[:, k]
        s_in = states[:, :, k].float()
        cum = torch.cumsum(A[:, k], dim=1)                         # (B, q, H)
        cq = cum[:, -1]                                            # (B, H)
        seg = (cum[:, :, None] - cum[:, None]).masked_fill(after[None, :, :, None], -torch.inf)
        D = torch.exp(seg)                                         # (B, t, s, H)
        M = D * torch.einsum("bthn,bshn->btsh", ck, bk)
        R = torch.einsum("bthp,bshp->btsh", gk, xk)
        DR = D * R
        K = M * R
        w = torch.exp(cq[:, None] - cum)
        e = torch.exp(cum)
        zb = torch.einsum("bshp,bhpn->bshn", xk, dS)
        zc = torch.einsum("bthp,bhpn->bthn", gk, s_in)
        dX[:, k] = (torch.einsum("btsh,bthp->bshp", M, gk)
                    + w[..., None] * torch.einsum("bshn,bhpn->bshp", bk, dS))
        dB[:, k] = torch.einsum("btsh,bthn->bshn", DR, ck) + w[..., None] * zb
        dC[:, k] = torch.einsum("btsh,bshn->bthn", DR, bk) + e[..., None] * zc
        wterm = w * (bk * zb).sum(-1)
        dcum = K.sum(2) - K.sum(1) + e * (ck * zc).sum(-1) - wterm
        dcum[:, -1] += torch.exp(cq) * (dS * s_in).sum((-1, -2)) + wterm.sum(1)
        dA[:, k] = dcum.flip(1).cumsum(1).flip(1)
        dS = (torch.exp(cq)[..., None, None] * dS
              + torch.einsum("bth,bthp,bthn->bhpn", e, gk, ck))
    return (*_unchunked(dX, dA, dB, dC, x, log_a, b, c), dS if need_init else None)


def _chunked(x, log_a, b, c, dy, chunk: int):
    """x, log_a, b, c and dy in f32 chunks: (B, nc, q, H, P) for x and
    dy, (B, nc, q, H) for log_a, (B, nc, q, H, N) for b and c (each head
    its group's), padded with ``ssd_scan_plain``'s identity steps."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q, nc = scan_chunk(L, chunk), chunk_count(L, chunk)
    pad = nc * q - L
    return (_padded(x, pad).reshape(B, nc, q, H, P), _padded(log_a, pad).reshape(B, nc, q, H),
            *(_padded(t, pad).reshape(B, nc, q, G, N).repeat_interleave(H // G, dim=3)
              for t in (b, c)),
            _padded(dy, pad).reshape(B, nc, q, H, P))


def _final_cotangent(x, b, d_final):
    """The final state's cotangent in f32, zeros for None."""
    B, _, H, P = x.shape
    return (torch.zeros((B, H, P, b.shape[3]), dtype=torch.float32, device=x.device)
            if d_final is None else d_final.float())


def _unchunked(dX, dA, dB, dC, x, log_a, b, c):
    """Chunked gradients (B, nc, q, ...) back to (B, L, ...) in the
    operands' dtypes, dB and dC summed over each group's heads."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Lp = dX.shape[1] * dX.shape[2]
    return (dX.reshape(B, Lp, H, P)[:, :L].to(x.dtype),
            dA.reshape(B, Lp, H)[:, :L].to(log_a.dtype),
            dB.reshape(B, Lp, G, H // G, N).sum(3)[:, :L].to(b.dtype),
            dC.reshape(B, Lp, G, H // G, N).sum(3)[:, :L].to(c.dtype))


def ssd_bwd_chunk_plain(x, log_a, b, c, dy, chunk: int = 128):
    """Stage (a) of the backward, chunk-parallel: each chunk's (e o
    dY)^T C, (B, H, nc, P, N) f32, with e_t = exp(cum_t), and cum_q, the
    chunk's whole log-decay, (B, H, nc)."""
    _, A, _, Cm, dY = _chunked(x, log_a, b, c, dy, chunk)
    cum = torch.cumsum(A, dim=2)                                   # (B, nc, q, H)
    E = torch.einsum("bkth,bkthp,bkthn->bhkpn", torch.exp(cum), dY, Cm)
    return E, cum[:, :, -1].transpose(1, 2)


def ssd_bwd_state_plain(E, cum_q, d_final):
    """Stage (b), the one sequential pass: from the last chunk, the dS
    leaving each chunk (B, H, nc, P, N) and dS = exp(cum_q) dS + (e o
    dY)^T C; returns (dS leaving each chunk, the initial state's
    gradient).  ``d_final`` f32 (B, H, P, N)."""
    dS, out = d_final, torch.empty_like(E)
    for k in reversed(range(E.shape[2])):
        out[:, :, k] = dS
        dS = torch.exp(cum_q[:, :, k])[..., None, None] * dS + E[:, :, k]
    return out, dS


def ssd_bwd_local_plain(x, log_a, b, c, states, dy, ds_out, chunk: int = 128):
    """Stage (c), chunk-parallel: every chunk's dX, dlog_a, dB and dC
    from its entering state (``states``) and the gradient of its leaving
    state (``ds_out``), both (B, H, nc, P, N), by ``ssd_scan_bwd_plain``'s
    formulas; returns (dx, dlog_a, db, dc) as it does."""
    X, A, Bm, Cm, dY = _chunked(x, log_a, b, c, dy, chunk)
    S, dS = states.float().transpose(1, 2), ds_out.transpose(1, 2)   # (B, nc, H, P, N)
    q = X.shape[2]
    cum = torch.cumsum(A, dim=2)                                    # (B, nc, q, H)
    cq = cum[:, :, -1]                                              # (B, nc, H)
    after = ~torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = (cum[:, :, :, None] - cum[:, :, None]).masked_fill(after[:, :, None], -torch.inf)
    D = torch.exp(seg)                                              # (B, nc, t, s, H)
    M = D * torch.einsum("bkthn,bkshn->bktsh", Cm, Bm)
    R = torch.einsum("bkthp,bkshp->bktsh", dY, X)
    DR, K = D * R, M * R
    w, e = torch.exp(cq[:, :, None] - cum), torch.exp(cum)
    zb = torch.einsum("bkshp,bkhpn->bkshn", X, dS)
    zc = torch.einsum("bkthp,bkhpn->bkthn", dY, S)
    dX = (torch.einsum("bktsh,bkthp->bkshp", M, dY)
          + w[..., None] * torch.einsum("bkshn,bkhpn->bkshp", Bm, dS))
    dB = torch.einsum("bktsh,bkthn->bkshn", DR, Cm) + w[..., None] * zb
    dC = torch.einsum("bktsh,bkshn->bkthn", DR, Bm) + e[..., None] * zc
    wterm = w * (Bm * zb).sum(-1)
    dcum = K.sum(3) - K.sum(2) + e * (Cm * zc).sum(-1) - wterm
    dcum[:, :, -1] += torch.exp(cq) * (dS * S).sum((-1, -2)) + wterm.sum(2)
    dA = dcum.flip(2).cumsum(2).flip(2)
    return _unchunked(dX, dA, dB, dC, x, log_a, b, c)


def ssd_scan_bwd_staged(x, log_a, b, c, states, dy, d_final=None, chunk: int = 128,
                        need_init: bool = True):
    """``ssd_scan_bwd_plain``'s gradients through the kernel's three
    stages in their plain versions: (a) each chunk's (e o dY)^T C, (b)
    the sequential dS pass, (c) the chunk-local rest."""
    E, cum_q = ssd_bwd_chunk_plain(x, log_a, b, c, dy, chunk)
    ds_out, d_init = ssd_bwd_state_plain(E, cum_q, _final_cotangent(x, b, d_final))
    return (*ssd_bwd_local_plain(x, log_a, b, c, states, dy, ds_out, chunk),
            d_init if need_init else None)


def ssd_scan_bwd_cuda(x, log_a, b, c, states, dy, d_final=None, chunk: int = 128,
                      need_init: bool = True):
    """Launch the backward kernel on operands the forward kernel takes
    (``contracts.SSD_SCAN``'s rules; ``KernelIneligibleError`` otherwise):
    ``states`` as the forward writes them under grad, ``dy`` and
    ``d_final`` the cotangents of y and of the final state (None: zeros)."""
    contracts.require(contracts.ssd_scan_verdict(x, log_a, b, c, None, chunk), NAME, BWD_NAME)
    return ssd_scan_bwd_launch(x, log_a, b, c, states, dy, d_final, chunk, need_init)


def _aligned(t):
    """t, or a copy of it on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_bwd_launch(x, log_a, b, c, states, dy, d_final, chunk: int,
                        need_init: bool = True):
    """The backward's launches alone, for operands the registry took
    (``ops``), counted as one ``ssd_scan_bwd`` launch: the staging pass
    where x, b, c or dy need it (``operand_mode``), then the kernels.
    dX, dlog_a, dB and dC come out in x's, log_a's, b's and c's dtypes,
    d_init in f32; the dS per chunk and the sums over a group's head
    blocks (and P slabs) go through f32 scratch (``bwd_launch_geometry``),
    reduced in a fixed order (past ``N_SLAB`` dX's per column slab
    too).  ``states`` at the build width, as the forward kernel writes
    them."""
    B, L, H, P = x.shape
    G, n = b.shape[2], b.shape[3]
    N, q, mode = build_width(n), scan_chunk(L, chunk), operand_mode(x, b, c, dy)
    la_bf16 = log_a.dtype != torch.float32       # dlog_a in 16 bits: bf16 or f16
    _, scratch = bwd_launch_geometry(B, L, H, P, G, N, chunk, mode, la_bf16)
    dev, lib = x.device, cuda.library()
    if mode == FAST:
        # the kernels read dy, states and d_final by 16-byte copies
        launch, xv, bv, cv, dyv = lib.cs_ssd_scan_bwd, x, b, c, _aligned(dy.contiguous())
        xp, xlo, blo = P, 0, 0
    else:
        launch, xp = lib.cs_ssd_scan_bwd_staged, -(-P // 8) * 8
        (xv, xlo), (bv, blo), (cv, _), (dyv, _) = (
            _split(x, xp), _split(b, N), _split(c, N), _split(dy, xp))
    xs, bs = xv.stride(), bv.stride()
    la = _log_a_f32(log_a)
    las = la.stride()
    states = _state_f32(states, N)
    d_final = None if d_final is None else _aligned(d_final.float().contiguous())
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    dla = torch.empty((B, L, H), dtype=log_a.dtype, device=dev)
    db = torch.empty((B, L, G, n), dtype=b.dtype, device=dev)
    dc = torch.empty((B, L, G, n), dtype=c.dtype, device=dev)
    d_init = torch.empty((B, H, P, n), dtype=torch.float32, device=dev) if need_init else None
    part = torch.empty(((scratch["states"] + scratch["cum"] + scratch["partials"]
                        + scratch["dx"]) // 4,), dtype=torch.float32, device=dev)
    lpart = (torch.empty((scratch["lpart"] // 4,), dtype=torch.float32, device=dev)
             if scratch["lpart"] else None)
    flags = (_out_flags(x.dtype, _OUT_F32, _OUT_F16) | _out_flags(b.dtype, _OUT_BC_F32, _OUT_BC_F16)
             | {torch.bfloat16: _OUT_LA_BF16, torch.float16: _OUT_LA_F16}.get(log_a.dtype, 0))
    rc = launch(
        xv.data_ptr(), la.data_ptr(), bv.data_ptr(), cv.data_ptr(), states.data_ptr(),
        dyv.data_ptr(), 0 if d_final is None else d_final.data_ptr(),
        dx.data_ptr(), dla.data_ptr(), db.data_ptr(), dc.data_ptr(),
        0 if d_init is None else d_init.data_ptr(), part.data_ptr(),
        0 if lpart is None else lpart.data_ptr(),
        B, L, H, P, G, N, q, xs[0], xs[1], las[0], las[1], bs[0], bs[1], xp, n, xlo, blo,
        flags, mode, cuda.stream_handle(x),
    )
    cuda.check(rc, BWD_NAME)
    cuda.record_launch(BWD_NAME)
    return dx, dla, db, dc, d_init


def bwd_occupancy(N: int, chunk: int = Q_MAX, mode: int = FAST) -> dict:
    """Blocks per SM of the backward's kernels, {"chunk", "state",
    "local"}, at build width N, ``chunk`` and operand ``mode``, from the
    CUDA runtime's occupancy calculator (builds the library)."""
    out = (ctypes.c_int * 3)()
    lib = cuda.library()
    rc = (lib.cs_ssd_scan_bwd_occupancy if mode == FAST else
          lib.cs_ssd_scan_bwd_occupancy_staged)(N, chunk, out)
    cuda.check(rc, BWD_NAME)
    return dict(zip(("chunk", "state", "local"), out))


class SsdScanFn(torch.autograd.Function):
    """The scan under autograd over a (forward, backward) pair:
    ``forward(x, log_a, b, c, init, chunk)`` -> (y, final state, chunk
    states), ``backward(x, log_a, b, c, states, dy, d_final, chunk,
    need_init)`` -> (dx, dlog_a, db, dc, d_init).  ``ops.ssd_scan`` gives
    it the kernels on the card and shapes only on meta tensors; the tests
    give it the plain pair.  A None ``init`` has no gradient, and a None
    cotangent (y or the final state unused) is zeros."""

    @staticmethod
    def forward(ctx, fwd, bwd, chunk, x, log_a, b, c, init):
        y, st, states = fwd(x, log_a, b, c, init, chunk)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, log_a, b, c, states)
        ctx.bwd, ctx.chunk = bwd, chunk
        return y, st

    @staticmethod
    def backward(ctx, dy, d_final):
        need = ctx.needs_input_grad[3:]
        if not any(need):
            return (None,) * 8
        x, log_a, b, c, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ctx.bwd(x, log_a, b, c, states, dy, d_final, ctx.chunk, need[4])
        return (None, None, None) + tuple(g if n else None for g, n in zip(grads, need))
