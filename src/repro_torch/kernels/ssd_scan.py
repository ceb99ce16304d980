"""Mamba-2 SSD chunked scan: the plain version and the kernel.

``cs_ssd_scan`` (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_pallas`` (``_ssd_kernel``).  The
Pallas grid walks the chunk axis in order and carries the (P, N) state
in VMEM; on the card a thread block loops over the chunks itself and
owns ``SLICE`` rows p of one (batch row, head)'s state, which stays on
chip throughout (grid: P slices x heads x batch rows).

Both take the time axis in chunks of ``q = min(chunk, L)`` when L is not
a multiple of ``chunk`` (else ``chunk``).  The plain version pads L to a
multiple of q with identity steps (log_a = 0 keeps the state, x = b = 0
adds nothing), as the JAX package's ``ops.ssd_scan`` does; the kernel
masks the ragged last chunk instead, which is the same arithmetic.

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
STATE_WIDTHS = (16, 64, 128)   # the N the kernel is built for (jamba, mamba2)
SMEM_LIMIT = 232_448  # shared bytes one block may use on an H100 (227 KB)
BWD_SLAB = 64         # P columns per block of the backward's chunk-parallel kernels
BWD_HEADS = 2         # heads per block of its chunk-local kernel, where a group's count is even


def scan_chunk(L: int, chunk: int) -> int:
    """The chunk the scan runs with: ``chunk``, or ``min(chunk, L)``
    when L is not a multiple of it."""
    return min(chunk, L) if L % chunk else chunk


def chunk_count(L: int, chunk: int) -> int:
    """The number of chunks the scan runs, the last one maybe ragged."""
    return -(-L // scan_chunk(L, chunk))


def launch_geometry(B: int, H: int, P: int, N: int, q: int):
    """(grid, threads, shared bytes) of the kernel for chunk q, as
    ``csrc/ssd_scan.cu`` lays them out (``SsdSmem``): rows = q rounded up
    to 16; B rows (rows x N bf16, sharing their bytes with the f32 state
    slice), the x slice (rows x SLICE bf16), the state's bf16 hi and lo
    halves, cum and the scan partials; row strides padded by 16 bytes."""
    rows = -(-q // 16) * 16
    ld = N + 8
    smem = (max(2 * rows * ld, 4 * SLICE * ld) + 2 * rows * (SLICE + 8)
            + 2 * 2 * SLICE * ld + 4 * rows + 4 * (THREADS // 32))
    return (-(-P // SLICE), H, B), THREADS, smem


def bwd_heads(H: int, G: int) -> int:
    """Heads per block of the backward's chunk-local kernel: a pair of
    one group's heads where the group's head count is even, else one."""
    return BWD_HEADS if (H // G) % 2 == 0 else 1


def bwd_launch_geometry(B: int, L: int, H: int, P: int, G: int, N: int, chunk: int):
    """The backward's launches, {name: (grid, threads, shared bytes)},
    and its f32 scratch in bytes, as ``csrc/ssd_scan.cu:launch_bwd`` lays
    them out (rows = q rounded up to 16, row pitches padded by 16 bytes):

    * ``chunk`` (a): C rows (rows x N bf16), a slab of dY rows (rows x
      BWD_SLAB bf16), e and the scan partials (``ChunkSmem``);
    * ``state`` (b): four f32 elements of a (b, h)'s P x N per thread;
    * ``local`` (c): B or C rows, x or dY rows of BWD_HEADS heads, the
      states' bf16 hi and lo halves of BWD_HEADS heads, cum, dcum and
      the w terms of each head, scan and reduction partials
      (``BwdSmem``);
    * ``sum``: dB and dC summed over a group's head blocks and P slabs.

    Scratch: ``states`` the dS leaving each chunk (B, H, nc, P, N),
    ``cum`` cum_q (B, H, nc, rounded up to 4 elements), ``partials`` the
    dB and dC partials (B, L, H / hb, nps, N) each, ``lpart`` dlog_a's
    per P slab (B, L, H, nps) when there is more than one slab."""
    q, nc = scan_chunk(L, chunk), chunk_count(L, chunk)
    rows = -(-q // 16) * 16
    nps, hb, warps = -(-P // BWD_SLAB), bwd_heads(H, G), THREADS // 32
    ldn, ldp = N + 8, BWD_SLAB + 8
    chunk_smem = 2 * rows * ldn + 2 * rows * ldp + 4 * rows + 4 * warps
    local_smem = (2 * rows * ldn + 2 * BWD_HEADS * rows * ldp + 2 * BWD_HEADS * 2 * BWD_SLAB * ldn
                  + 3 * 4 * BWD_HEADS * rows + 4 * 2 * BWD_HEADS * warps)
    launches = {
        "chunk": ((nc * nps, H, B), THREADS, chunk_smem),
        "state": ((-(-P * N // (4 * THREADS)), H, B), THREADS, 0),
        "local": ((nc * nps, H // hb, B), THREADS, local_smem),
        "sum": ((-(-B * L * G * N // THREADS),), THREADS, 0),
    }
    scratch = {
        "states": 4 * B * H * nc * P * N,
        "cum": 4 * (-(-B * H * nc // 4) * 4),
        "partials": 2 * 4 * B * L * (H // hb) * nps * N,
        "lpart": 4 * B * L * H * nps if nps > 1 else 0,
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
    """Launch the kernel.  x (B, L, H, P) bf16 and b, c (B, L, G, N) bf16
    are read through their batch and time strides (heads, groups and
    features must be packed, rows on 16-byte boundaries: no copy is
    made); P a multiple of 8, N one of ``STATE_WIDTHS``; log_a (B, L, H)
    f32 with packed heads; init_state (B, H, P, N) f32 must be contiguous
    (a view such as one layer of stacked caches is, and is read in
    place).  Operands the kernel does not take (``contracts.SSD_SCAN``)
    raise ``KernelIneligibleError``, a ``cuda.KernelError``."""
    contracts.require(contracts.ssd_scan_verdict(x, log_a, b, c, init_state, chunk), NAME)
    return ssd_scan_launch(x, log_a, b, c, init_state, chunk)


def ssd_scan_launch(x, log_a, b, c, init, chunk: int, states: bool = False):
    """The launch alone, for operands the registry took (``ops``).  With
    ``states`` the kernel also writes the state entering each chunk and
    the call returns (y, final state, states)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = scan_chunk(L, chunk)
    xs, bs, las = x.stride(), b.stride(), log_a.stride()
    y = torch.empty((B, L, H, P), dtype=torch.bfloat16, device=x.device)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    cst = (torch.empty((B, H, chunk_count(L, chunk), P, N), dtype=torch.float32,
                       device=x.device) if states else None)
    rc = cuda.library().cs_ssd_scan(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        0 if init is None else init.data_ptr(), y.data_ptr(), st.data_ptr(),
        0 if cst is None else cst.data_ptr(),
        B, L, H, P, G, N, q, xs[0], xs[1], las[0], las[1], bs[0], bs[1],
        cuda.stream_handle(x),
    )
    cuda.check(rc, NAME)
    cuda.record_launch(NAME)
    return (y, st, cst) if states else (y, st)


def ssd_scan_work(L: int, H: int, P: int, G: int, N: int, chunk: int, B: int = 1):
    """(flops, bytes) the scan needs: for each (b, h) and chunk of q
    steps, 2 flops per (t, s <= t) pair and feature of c.b and of the
    decayed mix of x, and 4qPN for the state's read-out and update;
    x, log_a, b, c and init read once, y and the state written once."""
    q = scan_chunk(L, chunk)
    flops = 0.0
    for t0 in range(0, L, q):
        n = min(q, L - t0)
        flops += n * (n + 1) * (N + P) + 4.0 * n * P * N
    flops *= B * H
    n_bytes = B * L * (H * P * 2 * 2 + H * 4 + 2 * G * N * 2) + 2 * B * H * P * N * 4
    return flops, n_bytes


def ssd_scan_bwd_work(L: int, H: int, P: int, G: int, N: int, chunk: int, B: int = 1):
    """(flops, bytes) the backward needs: for each (b, h) and chunk of q
    steps, 2 flops per (t, s <= t) pair and feature of C B^T, dY X^T,
    M^T dY, (D o R)^T C and (D o R) B, and 16qPN for the four products
    with the state and its gradient (B dS^T, X dS, dY S_in, (e o dY)^T C);
    x, log_a, b, c, dY, the chunk states and the final state's gradient
    read once, dX, dlog_a, dB, dC and the initial state's gradient
    written once."""
    q = scan_chunk(L, chunk)
    flops = 0.0
    for t0 in range(0, L, q):
        n = min(q, L - t0)
        flops += n * (n + 1) * (3 * N + 2 * P) + 8.0 * n * P * N
    flops *= B * H
    row = 3 * H * P * 2 + 2 * H * 4 + 4 * G * N * 2      # x, dY, dX; log_a, dlog_a; b, c, dB, dC
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
    y and of the final state.  Returns (dx in x's dtype, dlog_a f32, db
    and dc in b's and c's dtypes, d_init f32 or None)."""
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
    return (*_unchunked(dX, dA, dB, dC, x, b, c), dS if need_init else None)


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


def _unchunked(dX, dA, dB, dC, x, b, c):
    """Chunked gradients (B, nc, q, ...) back to (B, L, ...) in the
    operands' dtypes, dB and dC summed over each group's heads."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Lp = dX.shape[1] * dX.shape[2]
    return (dX.reshape(B, Lp, H, P)[:, :L].to(x.dtype), dA.reshape(B, Lp, H)[:, :L],
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
    return _unchunked(dX, dA, dB, dC, x, b, c)


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
    (``ops``), counted as one ``ssd_scan_bwd`` launch.  dX, dB and dC
    come out in bf16, dlog_a and d_init in f32; the dS per chunk and the
    sums over a group's head blocks (and P slabs) go through f32 scratch
    (``bwd_launch_geometry``), reduced in a fixed order."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    q = scan_chunk(L, chunk)
    _, scratch = bwd_launch_geometry(B, L, H, P, G, N, chunk)
    dev = x.device
    xs, bs, las = x.stride(), b.stride(), log_a.stride()
    # the kernels read dy, states and d_final by 16-byte copies
    dy = _aligned(dy.to(torch.bfloat16).contiguous())
    states = _aligned(states.float().contiguous())
    d_final = None if d_final is None else _aligned(d_final.float().contiguous())
    dx = torch.empty((B, L, H, P), dtype=torch.bfloat16, device=dev)
    dla = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    db, dc = (torch.empty((B, L, G, N), dtype=torch.bfloat16, device=dev) for _ in range(2))
    d_init = torch.empty((B, H, P, N), dtype=torch.float32, device=dev) if need_init else None
    part = torch.empty(((scratch["states"] + scratch["cum"] + scratch["partials"]) // 4,),
                       dtype=torch.float32, device=dev)
    lpart = (torch.empty((scratch["lpart"] // 4,), dtype=torch.float32, device=dev)
             if scratch["lpart"] else None)
    rc = cuda.library().cs_ssd_scan_bwd(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(), states.data_ptr(),
        dy.data_ptr(), 0 if d_final is None else d_final.data_ptr(),
        dx.data_ptr(), dla.data_ptr(), db.data_ptr(), dc.data_ptr(),
        0 if d_init is None else d_init.data_ptr(), part.data_ptr(),
        0 if lpart is None else lpart.data_ptr(),
        B, L, H, P, G, N, q, xs[0], xs[1], las[0], las[1], bs[0], bs[1],
        cuda.stream_handle(x),
    )
    cuda.check(rc, BWD_NAME)
    cuda.record_launch(BWD_NAME)
    return dx, dla, db, dc, d_init


def bwd_occupancy(N: int, chunk: int = Q_MAX) -> dict:
    """Blocks per SM of the backward's kernels, {"chunk", "state",
    "local"}, at state width N and ``chunk``, from the CUDA runtime's
    occupancy calculator (builds the library)."""
    out = (ctypes.c_int * 3)()
    cuda.check(cuda.library().cs_ssd_scan_bwd_occupancy(N, chunk, out), BWD_NAME)
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
