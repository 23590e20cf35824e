"""The plain versions' VJPs that back K6 and K8 on the card
(``flash_attention_vjp``, ``ssd_scan_vjp``) against ``jax.vjp`` of the JAX
references on the CPU, at the kernel tests' shapes (causal, window,
softcap, a value head dim of its own, cross, with and without an initial
state), within ``ATTN_VJP_RTOL`` / ``SSD_VJP_RTOL`` (``repro_torch.testing``);
and the autograd Functions' wiring, with the kernel forward replaced by
its plain version (there is no card here): gradients, launch and VJP
counts, and the dispatch of ``ops`` on CPU tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk
from repro_torch.testing import (ATTN_VJP_RTOL, FLASH_CASES, FLASH_DV_CASES,
                                 FLASH_RAGGED_CASES, SSD_CASES, SSD_VJP_RTOL,
                                 attention_case, rel_err, ssd_case)

torch.set_num_threads(1)

# (b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, softcap, q_offset)
ATTN_CASES = ([c[:6] + (c[5],) + c[6:] for c in FLASH_CASES
               + FLASH_RAGGED_CASES] + FLASH_DV_CASES)
# every SSD case with its own initial state, and the small ones without
SSD_VJP_CASES = SSD_CASES + [c[:6] + (False,) + c[7:] for c in SSD_CASES
                             if c[6] and c[1] * c[2] <= 256]


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the plain VJPs against jax.vjp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"attn{i}" for i in range(len(ATTN_CASES))])
def test_flash_attention_vjp_matches_jax(case):
    b, s_q, s_kv, n_q, n_kv, d, d_v, causal, window, cap, off = case
    q, k, v = attention_case(b, s_q, s_kv, n_q, n_kv, d, d_v=d_v)
    g = _cotangent((b, s_q, n_q, d_v), 7)
    kw = dict(causal=causal, window=window, softcap=cap)
    fa.vjps = 0
    got = fa.flash_attention_vjp(*map(_t, (q, k, v, g)), q_offset=_t(off),
                                 **kw)
    assert fa.vjps == 1
    # the JAX reference takes a scalar offset: a per-row offset row by row
    rows = [(slice(None), off)] if np.ndim(off) == 0 else [
        (slice(r, r + 1), o) for r, o in enumerate(off)]
    for sl, o in rows:
        _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention(
            q, k, v, q_offset=o, **kw), _j(q[sl]), _j(k[sl]), _j(v[sl]))
        for name, x, w in zip("qkv", got, vjp(_j(g[sl]))):
            assert x.shape == w.shape[:0] + x.shape
            assert rel_err(x.numpy()[sl], np.asarray(w)) <= ATTN_VJP_RTOL, \
                name


@pytest.mark.parametrize("case", SSD_VJP_CASES,
                         ids=[f"ssd{i}" for i in range(len(SSD_VJP_CASES))])
def test_ssd_scan_vjp_matches_jax(case):
    b, s, h, p, n, chunk, init, weak = case
    x, dt, A, B, C, st = ssd_case(b, s, h, p, n, init, weak=weak)
    gy, gf = _cotangent(x.shape, 3), _cotangent((b, h, p, n), 4)
    sk.vjps = 0
    got = sk.ssd_scan_vjp(*map(_t, (x, dt, A, B, C, gy, gf)), chunk=chunk,
                          initial_state=_t(st))
    assert sk.vjps == 1 and len(got) == 6 and (got[5] is None) == (not init)
    args = [_j(a) for a in (x, dt, A, B, C)] + ([_j(st)] if init else [])

    def f(*a):
        return jref.ssd_scan(*a[:5], chunk=chunk,
                             initial_state=a[5] if init else None)
    _, vjp = jax.vjp(jax.jit(f), *args)
    for name, x_, w in zip(["x", "dt", "A", "B", "C", "state"], got,
                           vjp((_j(gy), _j(gf)))):
        assert rel_err(x_.numpy(), np.asarray(w)) <= SSD_VJP_RTOL, name


# ---------------------------------------------------------------------------
# the autograd Functions, their kernel forward replaced by the plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def plain_forward(monkeypatch):
    """The Functions' forwards on the CPU: the kernel wrappers (which only
    take CUDA tensors) replaced by their plain versions, counted."""
    def counted(mod, fn):
        def call(*a, **kw):
            mod.launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(fa, "flash_attention",
                        counted(fa, fa.flash_attention_ref))
    monkeypatch.setattr(sk, "ssd_scan", counted(sk, sk.ssd_scan_ref))
    ops.reset_launch_counts()


def test_flash_attention_function_backward_is_the_plain_vjp(plain_forward):
    q, k, v = (torch.as_tensor(a).requires_grad_(i != 1) for i, a in
               enumerate(attention_case(2, 40, 80, 4, 2, 32, d_v=16)))
    kw = dict(causal=True, window=16, softcap=20.0, q_offset=24)
    out = fa.FlashAttention.apply(q, k, v, kw["causal"], kw["window"],
                                  kw["softcap"], kw["q_offset"])
    g = torch.as_tensor(_cotangent(tuple(out.shape), 1))
    dq, dv = torch.autograd.grad(out, (q, v), g)
    want = torch.autograd.grad(fa.flash_attention_ref(q, k, v, **kw),
                               (q, v), g)
    assert torch.equal(dq, want[0]) and torch.equal(dv, want[1])
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_vjp"] == 1


@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("final_cotangent", [True, False])
def test_ssd_scan_function_backward_is_the_plain_vjp(plain_forward, init,
                                                     final_cotangent):
    x, dt, A, B, C, st = (None if a is None else
                          torch.as_tensor(a).requires_grad_(True)
                          for a in ssd_case(2, 37, 4, 4, 4, init))
    leaves = [t for t in (x, dt, A, B, C, st) if t is not None]
    gy = torch.as_tensor(_cotangent((2, 37, 4, 4), 2))

    def loss(y, fin):
        # y always carries a cotangent; the final state too, or none
        return (y * gy).sum() + (fin.square().sum() if final_cotangent
                                 else 0.0)
    got = torch.autograd.grad(loss(*sk.SSDScan.apply(x, dt, A, B, C, 16, st)),
                              leaves)
    want = torch.autograd.grad(loss(*sk.ssd_scan_ref(
        x, dt, A, B, C, chunk=16, initial_state=st)), leaves)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    assert ops.launch_counts()["ssd_scan"] == 1
    assert ops.launch_counts()["ssd_scan_vjp"] == 1


def test_ops_route_only_cuda_tensors_through_the_functions(plain_forward):
    # a CPU operand that requires grad keeps the plain version under
    # autograd: no kernel, no Function, no counted VJP
    q, k, v = (torch.as_tensor(a).requires_grad_(True)
               for a in attention_case(1, 16, 16, 2, 1, 16))
    x, dt, A, B, C, _ = (torch.as_tensor(a).requires_grad_(True)
                         if a is not None else None
                         for a in ssd_case(1, 20, 2, 4, 4, False))
    (ops.flash_attention(q, k, v).sum()
     + ops.ssd_scan(x, dt, A, B, C, chunk=8)[0].sum()).backward()
    assert q.grad is not None and A.grad is not None
    assert all(n == 0 for n in ops.launch_counts().values())
