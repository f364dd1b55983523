"""Batched LoRa frame demodulator: complex baseband -> symbols.

The reference demodulator is a sample-consuming 5-state FSM
(/root/reference/LoRaDemod.cpp:145-327): FRAMESYNC retimes by consuming
N-value samples per window and integrates the fractional-bin offset into a
fine-CFO rotator; two downchirps give the coarse CFO; the quarter chirp
applies a joint time/frequency correction; then one data symbol per work().
Data-dependent `consume()` cannot exist under XLA's static shapes.

Batched reformulation (SURVEY.md §7 item 2):

  1. *Block-parallel coarse search*: dechirp-FFT every stride-N window of
     the block at once; inside a preamble every window reads the same bin v
     (a time shift of the base upchirp is a cyclic FFT shift, and windows
     straddling two identical preamble chirps are still exact cyclic
     shifts).  The frame alignment is t0 = w*N + (N - v) mod N from the
     strongest agreeing window pair — one gather instead of a retiming walk.
  2. *Short sync scan*: a lax.scan over at most MAX_SYNC_SEARCH aligned
     windows emulates the FRAMESYNC contract exactly — sync match via
     (value+4)/8 quantization against the sync nibbles with the two-symbol
     lookahead (LoRaDemod.cpp:183-206), fine-CFO integration of f_index on
     non-sync windows (:220), reset on squelch (:232).
  3. Downchirp pair -> signed coarse CFO, averaged with C truncation
     (:246-265); quarter-chirp step consumes N/4 + freqError/2 and folds
     freqError/2 into the fine CFO (:278-279).
  4. *Batched payload*: all MTU data windows are gathered at the resolved
     offset and detected in one fused dechirp+FFT+argmax; the squelch cut
     becomes a mask (the squelched symbol is included in the packet, as in
     the reference :290-301).

Everything is static-shape; per-frame timing enters only through traced
dynamic-slice starts, so the whole demodulator jits once per (config,
buffer length) and vmaps over channel banks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LoRaConfig
from ..ops import cplx
from ..ops import detect as det_ops
from ..ops import shift as shift_ops
from ..ops.cplx import IQ

MAX_SYNC_SEARCH = 13  # aligned windows scanned for the sync word (>= 9
#                       remaining preamble + 2 sync + margin)
N_TRACK_WIN = MAX_SYNC_SEARCH + 4  # scan + 2 downchirps + quarter margin
TRACK_ROWS = N_TRACK_WIN + 1  # aligned rows gathered (one more for the shift)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DemodResult:
    """Per-frame demod outputs (leading axes = batch)."""

    symbols: jax.Array     # int16 [..., mtu] detected data symbols
    count: jax.Array       # int32 [...] symbols in the packet (incl. squelched)
    found: jax.Array       # bool [...] sync word matched
    freq_error: jax.Array  # int32 [...] coarse CFO, bins (signal `error`)
    fine_freq: jax.Array   # float32 [...] fine CFO at data start, bins
    power: jax.Array       # float32 [...] dB (signal `power`)
    snr: jax.Array         # float32 [...] dB (signal `snr`)
    t_sync: jax.Array      # int32 [...] sample index of the sync-word symbol
    consumed: jax.Array    # int32 [...] samples consumed through the packet
    found_pre: Optional[jax.Array] = None   # bool [...] coarse preamble hit
    t_candidate: Optional[jax.Array] = None # int32 [...] coarse-aligned start
    # bool [...]: found AND the whole mtu payload lies inside this buffer
    # (False => data_start was clamped and `symbols` are truncated garbage;
    # callers streaming across buffers should re-aim from t_candidate)
    payload_complete: Optional[jax.Array] = None
    dec: Optional[IQ] = None          # planar IQ [..., mtu, N] dechirped (debug)
    fft_mag2: Optional[jax.Array] = None  # float32 [..., mtu, N] spectra (debug)
    raw: Optional[IQ] = None  # planar IQ [..., mtu, N] aligned payload sample
    #                           windows (the reference's `raw` input-copy tap,
    #                           LoRaDemod.cpp:81,152-154) (debug)


def payload_rows(N: int, mtu: int) -> int:
    """Aligned N-sample rows the payload stage may address per frame: the
    next multiple of 8 strictly above mtu, plus 8 more when those rows
    exceed 2**18 samples.  Only mtu + 1 rows are gathered; the rest is
    slack that fixes data_start's clipping bound (and so every result)
    where an earlier tiled kernel put it."""
    rp = 8 * (mtu // 8 + 1)
    return rp if rp * N <= 1 << 18 else rp + 8


def required_samples(cfg: LoRaConfig, search_symbols: int = 4) -> int:
    """Minimum buffer length for demodulate(): search margin + preamble +
    sync + downchirps + quarter + MTU payload (padded to payload_rows) +
    retime slack.

    Always a multiple of N: the quarter-chirp consume is rounded up to a
    whole symbol so the [B, W, N] row view the coarse detector reads is a
    free reshape of the buffer (T % N != 0 would make the xb[:, :W*N]
    slice a real copy).  The row count W = T // N is additionally padded
    so (W - payload_rows) % 8 == 0, a grid an earlier kernel needed; it
    stays so that results do not move."""
    N = cfg.N
    rp = payload_rows(N, cfg.mtu)
    head = cfg.preamble_symbols + 2 + 2 + 1
    w = search_symbols + head + max(cfg.mtu + 1, rp) + 1
    w += (-(w - rp)) % 8
    return w * N


def _trunc_half(x: jax.Array) -> jax.Array:
    """C-style integer division by 2 (truncates toward zero)."""
    return jnp.sign(x) * (jnp.abs(x) // 2)


def _coarse_detect(xb: IQ, cfg: LoRaConfig):
    """Stage 1 detect: dechirp-detect every stride-N window of every
    channel in ONE batched [B, W, N] call, outside the per-channel
    alignment vmap.  Returns (v, snr0, pwr), each [B, W]."""
    B, T = xb.shape
    N = cfg.N
    W = T // N
    win = xb[:, : W * N].reshape(B, W, N)
    d0 = det_ops.dechirp_detect(win)
    return d0.value, d0.power - d0.noise, d0.power


def _coarse(v, snr0, pwr, cfg: LoRaConfig):
    """Stage 1 epilogue (per channel, under vmap): pairwise agreement map
    for the preamble search over per-window detections v/snr0/pwr [W]."""
    N = cfg.N
    dv = jnp.abs(v[:-1] - v[1:])
    dist = jnp.minimum(dv, N - dv)
    pair_snr = jnp.minimum(snr0[:-1], snr0[1:])
    # absolute floor rejects degenerate all-zero windows (no signal, no
    # noise), whose 0/0 spectra read bin 0 at "0 dB SNR" and would
    # otherwise form fake preamble runs in idle stretches
    pair_pow = jnp.minimum(pwr[:-1], pwr[1:])
    agree = (
        (dist <= 2) & (pair_snr > jnp.float32(cfg.thresh)) & (pair_pow > -200.0)
    )
    return agree, pair_snr, v


def _extend_run(cfg: LoRaConfig, agree, v, first_w, T: int):
    """Extend the run of agreeing pairs at `first_w` to its end, so the
    sync scan starts at the *tail* of the preamble regardless of preamble
    length (the reference FSM walks the preamble one window at a time,
    LoRaDemod.cpp:179-237; here the scan budget is MAX_SYNC_SEARCH windows
    from t0).

    The alignment value is the CIRCULAR MEDIAN of v over the run's
    windows, not the last window's argmax alone: near the SNR threshold a
    single noise-flipped argmax (+-1 bin) would misalign the whole scan
    block by one sample, turning every preamble detection into N-1
    (q = 16 != 0) and blinding the sync gate.  The reference FSM retimes
    on every window, so one bad argmax is transient there
    (LoRaDemod.cpp:212-218 consume(N - value)); the batch equivalent of
    that per-window self-correction is majority voting the run (measured:
    recovers the FSM's sensitivity margin in
    tools/bench_sensitivity.py's paired head-to-head)."""
    N = cfg.N
    idx_w = jnp.arange(agree.shape[0], dtype=jnp.int32)
    brk = (idx_w >= first_w) & ~agree
    first_brk = jnp.where(jnp.any(brk), jnp.argmax(brk), agree.shape[0])
    last_w = jnp.maximum(first_brk - 1, first_w).astype(jnp.int32)
    v_ref = v[last_w + 1]
    idx_v = jnp.arange(v.shape[0], dtype=jnp.int32)
    in_run = (idx_v >= first_w) & (idx_v <= last_w + 1)
    # circular deltas relative to v_ref; run windows cluster within a few
    # bins, so the (N/2)-centered fold is safe
    delta = jnp.mod(v.astype(jnp.int32) - v_ref + N // 2, N) - N // 2
    big = jnp.int32(N)  # > any folded delta; sorts after every run value
    cnt = jnp.sum(in_run).astype(jnp.int32)
    d_sorted = jnp.sort(jnp.where(in_run, delta, big))
    d_med = d_sorted[jnp.maximum(cnt - 1, 0) // 2]
    v_sel = jnp.mod(v_ref + d_med, N)
    t_cand = (last_w * N + ((N - v_sel) % N)).astype(jnp.int32)
    # clamp so the scan block fits entirely (TRACK_ROWS aligned rows for
    # the row+shift gather): the gathered rows then match t0 exactly and
    # t_sync stays truthful even when the frame's tail is not in this
    # buffer (callers re-aim from t_candidate)
    t0 = jnp.clip(t_cand, 0, T - TRACK_ROWS * N).astype(jnp.int32)
    return t_cand, t0


def _scan_track(xs: IQ, cfg: LoRaConfig, t0, t_cand, found_pre, T: int):
    """Stages 2-4 on aligned window blocks xs [M, N_TRACK_WIN, N], batched
    over all M candidates at once (channels, or channels x frame slots
    flattened): sync scan, downchirp CFO, quarter-chirp correction.

    The scan runs outside any per-candidate vmap and each step issues one
    flat [M, 2, N] detect: the step's current window and its lookahead
    share the carried fine-CFO state, so pairing them halves the
    sequential chain of steps.  Per-candidate results are bit-identical
    to a vmapped scalar scan."""
    N = cfg.N
    M = t0.shape[0]
    thresh = jnp.float32(cfg.thresh)
    sync0 = cfg.sync >> 4
    sync1 = cfg.sync & 0xF

    def row_pair(k):
        # rows [k, k+1] of every candidate: one contiguous 2-row slice
        return jax.tree.map(
            lambda a: jax.lax.dynamic_slice_in_dim(a, k, 2, axis=1), xs
        )

    def sync_step(carry, k):
        state, ferr, prev_q, k_sync = carry  # each [M]
        d2 = det_ops.dechirp_detect(row_pair(k), ferr=ferr[:, None])
        squelched = (d2.power[:, 0] - d2.noise[:, 0]) < thresh
        q = (d2.value[:, 0] + 4) // 8
        q1 = (d2.value[:, 1] + 4) // 8
        searching = state == 0
        is_sync = (
            searching
            & ~squelched
            & (prev_q == 0)
            & (q == sync0)
            & (q1 == sync1)
        )
        new_state = jnp.where(is_sync, 1, state)
        new_ksync = jnp.where(is_sync, k, k_sync)
        # fine-CFO integrator on non-sync preamble windows; reset on squelch
        new_ferr = jnp.where(
            searching & ~is_sync & ~squelched,
            ferr + d2.f_index[:, 0],
            jnp.where(searching & squelched, 0.0, ferr),
        )
        # the reference stores _prevValue after *every* window, squelched
        # ones included (LoRaDemod.cpp:326)
        new_prev = jnp.where(searching, q, prev_q)
        return (new_state, new_ferr, new_prev, new_ksync), None

    init = (
        jnp.zeros((M,), jnp.int32),
        jnp.zeros((M,), jnp.float32),
        jnp.full((M,), 999, jnp.int32),
        jnp.zeros((M,), jnp.int32),
    )
    (state, ferr, _, k_sync), _ = jax.lax.scan(
        sync_step, init, jnp.arange(MAX_SYNC_SEARCH, dtype=jnp.int32)
    )
    found = found_pre & (state == 1)

    # ---- 3. downchirps: coarse CFO — per-candidate 2-row gather at
    # k_sync + 2, then one stacked [M, 2, N] down-chirp detect
    t_dc = t0 + (k_sync + 2) * N
    idx = k_sync[:, None] + jnp.arange(2, 4, dtype=jnp.int32)[None]
    rows_dc = jax.tree.map(
        lambda a: jnp.take_along_axis(a, idx[:, :, None], axis=1), xs
    )
    ddc = det_ops.dechirp_detect(rows_dc, down=True, ferr=ferr[:, None])

    def signed(val):
        return jnp.where(val > N // 2, val - N, val).astype(jnp.int32)

    freq_error = _trunc_half(signed(ddc.value[:, 0]) + signed(ddc.value[:, 1]))
    power = ddc.power[:, 1]
    snr = ddc.power[:, 1] - ddc.noise[:, 1]

    # ---- 4. quarter-chirp joint time/frequency correction ------------------
    fine_total = ferr + _trunc_half(freq_error).astype(jnp.float32)
    data_start = t_dc + 2 * N + N // 4 + _trunc_half(freq_error)
    room = max(0, T - payload_rows(cfg.N, cfg.mtu) * N)
    fits = data_start <= room
    data_start = jnp.clip(data_start, 0, room).astype(jnp.int32)

    head = DemodResult(
        symbols=jnp.zeros((M,), jnp.int16),  # filled by _payload_epilogue
        count=jnp.zeros((M,), jnp.int32),
        found=found,
        freq_error=jnp.where(found, freq_error, 0),
        fine_freq=jnp.where(found, fine_total, 0.0),
        power=power,
        snr=snr,
        t_sync=(t0 + k_sync * N).astype(jnp.int32),
        consumed=data_start,  # finalized with count in _payload_epilogue
        found_pre=found_pre,
        t_candidate=t_cand,
        payload_complete=found & fits,
    )
    return head, fine_total


def _align_frame(v, snr0, pwr, cfg: LoRaConfig, T: int):
    """Single strongest-frame alignment (max_frames=1): earliest agreeing
    pair within 6 dB of the strongest (robust against noise windows passing
    the reference's permissive default threshold).  Consumes per-window
    detections from _coarse_detect (the detect itself runs outside the
    vmap; this epilogue is cheap elementwise work over [W])."""
    agree, pair_snr, v = _coarse(v, snr0, pwr, cfg)
    score = jnp.where(agree, pair_snr, -jnp.inf)
    good = agree & (score >= jnp.max(score) - 6.0)
    first_w = jnp.argmax(good)
    found_pre = jnp.any(good)
    t_cand, t0 = _extend_run(cfg, agree, v, first_w, T)
    return t_cand, t0, found_pre


def _align_multi(v, snr0, pwr, cfg: LoRaConfig, max_frames: int, T: int):
    """Multi-frame alignment: the first `max_frames` runs of agreeing pairs,
    in time order (false runs fail the sync scan and report found=False).
    The 6 dB near-far filter is skipped — coexisting frames may differ in
    power."""
    agree, _, v = _coarse(v, snr0, pwr, cfg)
    idx_w = jnp.arange(agree.shape[0], dtype=jnp.int32)
    run_start = agree & ~jnp.concatenate([jnp.array([False]), agree[:-1]])
    # a real preamble (>= 6 chirps) yields >= 4 consecutive agreeing pairs;
    # requiring 3 discards the 1-2-pair runs every frame's identical
    # downchirp pair (and chance data agreements) would otherwise spawn
    a1 = jnp.concatenate([agree[1:], jnp.array([False])])
    a2 = jnp.concatenate([agree[2:], jnp.array([False, False])])
    run_start = run_start & a1 & a2
    sentinel = agree.shape[0]
    starts = jnp.sort(jnp.where(run_start, idx_w, sentinel))[:max_frames]
    valid = starts < sentinel
    fw = jnp.minimum(starts, sentinel - 1)
    t_cand, t0 = jax.vmap(
        lambda f: _extend_run(cfg, agree, v, f, T)
    )(fw)
    return t_cand, t0, valid


def _payload_epilogue(head: DemodResult, dd, cfg: LoRaConfig):
    """Squelch cut + packet framing over batched payload detections [B, mtu]
    (reference semantics: the squelched symbol is included,
    LoRaDemod.cpp:290-301)."""
    thresh = jnp.float32(cfg.thresh)
    snr_d = dd.power - dd.noise
    squelched_d = snr_d < thresh
    any_sq = jnp.any(squelched_d, axis=-1)
    first_sq = jnp.argmax(squelched_d, axis=-1)
    count = jnp.where(any_sq, jnp.minimum(first_sq + 1, cfg.mtu), cfg.mtu)
    count = jnp.where(head.found, count, 0).astype(jnp.int32)
    sym_mask = jnp.arange(cfg.mtu) < count[..., None]
    symbols = jnp.where(sym_mask, dd.value, 0).astype(jnp.int16)
    data_start = head.consumed
    return dataclasses.replace(
        head,
        symbols=symbols,
        count=count,
        consumed=jnp.where(head.found, data_start + count * cfg.N, 0).astype(
            jnp.int32
        ),
    )


def _head_stage(xb: IQ, cfg: LoRaConfig, max_frames: int):
    """Alignment + tracking (stages 1-3): pad, coarse preamble search,
    sync scan + CFO.  Returns (padded xb, head result, fine CFO, t0)."""
    need = required_samples(cfg)
    if xb.shape[-1] < need:  # static: pad short buffers to the demod window
        xb = cplx.pad(xb, ((0, 0), (0, need - xb.shape[-1])))
    T = xb.shape[-1]
    with jax.named_scope("coarse_detect"):
        cv, csnr, cpwr = _coarse_detect(xb, cfg)
    with jax.named_scope("align"):
        if max_frames == 1:
            t_cand, t0, found_pre = jax.vmap(
                lambda v, s, p: _align_frame(v, s, p, cfg, T)
            )(cv, csnr, cpwr)
        else:
            t_cand, t0, found_pre = jax.vmap(
                lambda v, s, p: _align_multi(v, s, p, cfg, max_frames, T)
            )(cv, csnr, cpwr)
    with jax.named_scope("track"):
        # scan window block: row-granular gather + sub-N shift, exactly
        # like the payload stage below.  Bit-identical to slicing
        # x[t0 : t0+N_TRACK_WIN*N]: _extend_run clips t0 to
        # T - TRACK_ROWS*N, so the row clamp never engages.
        xs = shift_ops.shift_windows(
            shift_ops.gather_rows(xb, t0 // cfg.N, TRACK_ROWS, cfg.N),
            t0 % cfg.N,
            N_TRACK_WIN,
        )
        if max_frames == 1:
            head, fine_total = _scan_track(xs, cfg, t0, t_cand, found_pre, T)
        else:
            # flatten the [B, K] candidate grid into one batch for the scan
            B, K = t0.shape
            flat = lambda a: a.reshape(B * K, *a.shape[2:])
            head, fine_total = _scan_track(
                jax.tree.map(flat, xs), cfg,
                flat(t0), flat(t_cand), flat(found_pre), T,
            )
            unflat = lambda a: a.reshape(B, K, *a.shape[1:])
            head = jax.tree.map(unflat, head)
            fine_total = unflat(fine_total)
    return xb, head, fine_total, t0


def _payload_stage(
    xb: IQ, head: DemodResult, fine_total, t0,
    cfg: LoRaConfig, debug: bool, spectra: bool,
):
    """Stage 4 + epilogue: payload gather, detect, symbol emission.

    spectra=True carries the payload |FFT|^2 windows (fft_mag2) for
    soft-decision decoding (models/softdec) without the debug taps'
    raw/dec arrays — the production soft-RX route."""
    # payload gather: whole rows on the N-grid, then the sub-window shift
    data_start = head.consumed
    dec = raw = None
    xd = shift_ops.shift_windows(
        shift_ops.gather_rows(xb, data_start // cfg.N, cfg.mtu + 1, cfg.N),
        data_start % cfg.N,
        cfg.mtu,
    )
    if debug:  # keep the raw/dechirped taps + spectra (the reference's
        # raw/dec/fft debug ports)
        raw = xd
        dec = det_ops.dechirp(xd, ferr=fine_total[..., None])
        dd = det_ops.detect(dec, want_mag2=True)
    else:
        dd = det_ops.dechirp_detect(
            xd, ferr=fine_total[..., None], want_mag2=spectra
        )
    # consumed temporarily holds data_start; restore t0 for the not-found
    # lanes after the epilogue computes the real value
    res = _payload_epilogue(head, dd, cfg)
    return dataclasses.replace(
        res,
        consumed=jnp.where(res.found, res.consumed, t0).astype(jnp.int32),
        dec=dec,
        fft_mag2=dd.mag2 if (debug or spectra) else None,
        raw=raw,
    )


def demodulate(
    x: jax.Array, cfg: LoRaConfig, debug: bool = False, max_frames: int = 1,
    spectra: bool = False,
):
    """Demodulate frames out of each channel buffer.

    x: planar IQ (or complex array, converted) [B, T] (or [T]) baseband at
    1 sample/chip; buffers shorter than required_samples(cfg) are padded.
    Returns a :class:`DemodResult`; with debug=True it also carries the
    aligned payload sample windows, their dechirped copies and spectra (the
    reference's `raw`/`dec`/`fft` debug ports, LoRaDemod.cpp:81-83).

    max_frames > 1 tracks up to that many frames per buffer in one call
    (result leaves gain a trailing candidate axis [..., K]; candidates are
    time-ordered, unused slots report found=False).  Memory and payload
    compute scale with K.

    spectra=True additionally carries the payload |FFT|^2 windows in
    fft_mag2 — the input of the soft-decision decoder (api.decode_soft) —
    without the raw/dec debug taps.
    """
    x = cplx.as_iq(x)
    squeeze = x.ndim == 1
    xb = x if not squeeze else x.reshape(1, -1)
    from ..utils import debugcheck

    if debugcheck.armed() and not debug:
        # sanitizer armed: route through the spectra-carrying payload path
        # so the dechirped payload windows are actually inspected
        spectra = True
    res = _demod_whole(xb, cfg, debug, max_frames, spectra)
    if debugcheck.armed():
        T = max(xb.shape[-1], required_samples(cfg))
        debugcheck.check_demod(res, cfg, T)
    if squeeze:
        res = jax.tree.map(lambda a: a[0], res)
    return res


@functools.partial(
    jax.jit, static_argnames=("cfg", "debug", "max_frames", "spectra")
)
def _demod_whole(
    xb: IQ, cfg: LoRaConfig, debug: bool, max_frames: int,
    spectra: bool = False,
):
    xb, head, fine_total, t0 = _head_stage(xb, cfg, max_frames)
    with jax.named_scope("payload_detect"):
        return _payload_stage(xb, head, fine_total, t0, cfg, debug, spectra)
