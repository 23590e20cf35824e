"""The LLM path's kernel layer on the CPU: the plain PyTorch versions of K6
(flash attention), K7 (decode attention), K8 (SSD scan) and the plain
``ssd_step`` against the JAX functions they port, run as the JAX package's
own tests run them (the jnp oracle and the Pallas kernels in interpret
mode).  The CUDA kernels are held against these plain versions on the card
by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import ops
from repro_torch.testing import (ATTN_ATOL, DECODE_CASES, FLASH_CASES,
                                 SSD_CASES, SSD_RTOL, attention_case,
                                 decode_case, rel_err, ssd_case)

torch.set_num_threads(1)


def _t(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K6 flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"flash{i}" for i in range(len(FLASH_CASES))])
def test_flash_attention_plain_matches_jax(case):
    b, s_q, s_kv, n_q, n_kv, d, causal, window, cap, off = case
    q, k, v = attention_case(b, s_q, s_kv, n_q, n_kv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    want = np.asarray(jref.flash_attention(*_j((q, k, v)), **kw))
    want_kernel = np.asarray(jflash(*_j((q, k, v)), bq=16, bk=16,
                                    interpret=True, **kw))
    ops.reset_launch_counts()
    got = ops.flash_attention(*_t((q, k, v)), **kw).numpy()
    assert ops.launch_counts()["flash_attention"] == 0     # plain on CPU
    assert got.shape == (b, s_q, n_q, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL, rtol=0)


def test_flash_attention_per_row_offset_matches_jax_rows():
    # the JAX reference adds q_offset to arange(s_q) and is right only for a
    # scalar, so each batch row is checked alone against it (b = 1 slices)
    q, k, v = attention_case(3, 24, 64, 4, 2, 64, seed=5)
    offs = np.asarray([0, 17, 40], np.int32)
    kw = dict(causal=True, window=20, softcap=30.0)
    got = ops.flash_attention(*_t((q, k, v)), q_offset=torch.as_tensor(offs),
                              **kw).numpy()
    for i, off in enumerate(offs):
        want = np.asarray(jref.flash_attention(
            *_j((q[i:i + 1], k[i:i + 1], v[i:i + 1])), q_offset=int(off),
            **kw))
        np.testing.assert_allclose(got[i:i + 1], want, atol=ATTN_ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# K7 decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"decode{i}" for i in range(len(DECODE_CASES))])
def test_decode_attention_plain_matches_jax(case):
    b, S, n_q, n_kv, d, clen, window, cap = case
    q, kc, vc = decode_case(b, S, n_q, n_kv, d)
    cl = np.asarray(clen, np.int32)
    kw = dict(window=window, softcap=cap)
    want = np.asarray(jref.decode_attention(*_j((q, kc, vc, cl)), **kw))
    want_kernel = np.asarray(jdecode(*_j((q, kc, vc, cl)), bk=32,
                                     interpret=True, **kw))
    got = ops.decode_attention(*_t((q, kc, vc, cl)), **kw).numpy()
    assert got.shape == (b, n_q, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# K8 SSD scan and the plain decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_CASES))])
def test_ssd_scan_plain_matches_jax(case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    y_ref, fin_ref = jref.ssd_scan(*_j((x, dt, A, B, C)), chunk=chunk,
                                   initial_state=_j((st,))[0])
    y_k, fin_k = jssd(*_j((x, dt, A, B, C)), chunk=chunk,
                      initial_state=_j((st,))[0], interpret=True)
    y, fin = ops.ssd_scan(*_t((x, dt, A, B, C)), chunk=chunk,
                          initial_state=_t((st,))[0])
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    for got, want in ((y, y_ref), (fin, fin_ref), (y, y_k), (fin, fin_k)):
        assert rel_err(got.numpy(), np.asarray(want)) <= SSD_RTOL


def test_ssd_step_plain_matches_jax_and_continues_the_scan():
    b, s, h, p, n = 2, 12, 3, 8, 16
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, seed=3)
    y_j, st_j = jref.ssd_step(*_j((x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                   st)))
    y_t, st_t = ops.ssd_step(*_t((x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                  st)))
    assert rel_err(y_t.numpy(), np.asarray(y_j)) <= SSD_RTOL
    assert rel_err(st_t.numpy(), np.asarray(st_j)) <= SSD_RTOL
    # a scan over s - 1 steps then one step equals the scan over s steps
    xt, dtt, At, Bt, Ct, stt = _t((x, dt, A, B, C, st))
    y_all, fin_all = ops.ssd_scan(xt, dtt, At, Bt, Ct, chunk=4,
                                  initial_state=stt)
    _, fin_head = ops.ssd_scan(xt[:, :-1], dtt[:, :-1], At, Bt[:, :-1],
                               Ct[:, :-1], chunk=4, initial_state=stt)
    y_last, fin_last = ops.ssd_step(xt[:, -1], dtt[:, -1], At, Bt[:, -1],
                                    Ct[:, -1], fin_head)
    assert rel_err(y_last.numpy(), y_all[:, -1].numpy()) <= SSD_RTOL
    assert rel_err(fin_last.numpy(), fin_all.numpy()) <= SSD_RTOL


@pytest.mark.parametrize("args,want", [
    ((4, 512, 32, None), (64, 8)),      # zamba2's decode: 1,024 blocks
    ((4, 512, 16, 64), (64, 1)),        # a window of 64: one split
    ((1, 32768, 8, None), (256, 128)),  # a long cache: splits of 256
    ((8, 4096, 128, None), (4096, 1)),  # 1,024 (row, kv-head) pairs
    ((2, 100, 3, None), (64, 2))])      # splits of at least 64 slots
def test_decode_splits_follow_the_longest_known_length(args, want):
    # K7's wrapper cuts the longest valid length it knows without reading
    # the device (S, or a shorter window) into whole 32-slot tiles, aiming
    # at ~1,024 blocks
    from repro_torch.kernels import decode_attention as da
    per, nsplit = da.splits(*args)
    assert (per, nsplit) == want
    longest = min(args[1], args[3] or args[1])
    assert per % 32 == 0 and per * nsplit >= longest > per * (nsplit - 1)


@pytest.mark.parametrize("p,n,path", [(64, 64, "tensor cores"),
                                      (64, 128, "tensor cores"),
                                      (32, 16, "tensor cores"),
                                      (4, 4, "CUDA cores"),
                                      (64, 20, "CUDA cores")])
def test_ssd_scan_path_is_chosen_by_shape(p, n, path):
    from repro_torch.kernels import ssd_scan as sk
    assert sk.path(p, n) == path
