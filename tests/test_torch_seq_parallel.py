"""The port's sequence parallelism (``blades_tpu_torch/ops/ring_attention.py``,
``ops/ulysses.py`` and the text models' ``ring_mesh``) against the JAX
package's on the conftest's 8-device CPU mesh.

The port's ``seq`` mesh is 8 entries of the CPU (the virtual mesh); the
JAX package's is its 8 forced host devices. The same numpy-seeded q, k, v
``[B, N, H, Dh]`` and key masks go to both. Tolerances:

- outputs of ring and Ulysses attention: ``rtol=atol=1e-5`` against the
  JAX package's, and against the port's dense ``attention_reference``;
- gradients of ``sum(out ** 2)`` with respect to q, k and v: each within a
  relative L2 error of 1e-4 of the JAX package's, leaf by leaf;
- ``long_text_transformer(mesh=...)`` logits, a narrow twin (vocabulary
  40, width 16, 8 heads, 64 tokens) with the JAX init carried over by
  ``params_from_jax``: ``rtol=atol=1e-5`` against the JAX package's ring
  and Ulysses models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import text as jax_text
from blades_tpu.ops.ring_attention import ring_attention as jax_ring
from blades_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from blades_tpu_torch.models import build_fns, params_from_jax, text
from blades_tpu_torch.ops.ring_attention import attention_reference, ring_attention
from blades_tpu_torch.ops.ulysses import ulysses_attention
from blades_tpu_torch.parallel import Mesh
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

SEQ = "seq"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-4
SCHEDULES = {"ring": (ring_attention, jax_ring), "ulysses": (ulysses_attention, jax_ulysses)}


def _meshes(n=8):
    return (Mesh([torch.device("cpu")] * n, (SEQ,)),
            JaxMesh(np.array(jax.devices()[:n]), (SEQ,)))


def _qkv(seed, b=2, n=64, h=8, d=4):
    r = np.random.RandomState(seed)
    return [r.randn(b, n, h, d).astype(np.float32) for _ in range(3)]


def _mask(b, n, seed):
    lens = np.random.RandomState(seed).randint(1, n + 1, (b, 1))
    lens[0] = n // 3
    return np.arange(n)[None, :] < lens


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_attention_matches_jax(schedule, masked):
    port_fn, jax_fn = SCHEDULES[schedule]
    pmesh, jmesh = _meshes()
    q, k, v = _qkv(1)
    mask = _mask(2, 64, 2) if masked else None
    want = np.asarray(jax_fn(*map(jnp.asarray, (q, k, v)), jmesh, SEQ,
                             kv_mask=None if mask is None else jnp.asarray(mask)))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = port_fn(*map(torch.from_numpy, (q, k, v)), pmesh, SEQ, kv_mask=tmask)
    assert got.shape == (2, 64, 8, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = attention_reference(*map(torch.from_numpy, (q, k, v)), kv_mask=tmask)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_gradients_match_jax(schedule):
    port_fn, jax_fn = SCHEDULES[schedule]
    pmesh, jmesh = _meshes()
    q, k, v = _qkv(3, n=16)
    mask = _mask(2, 16, 4)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jax_fn(a, b, c, jmesh, SEQ,
                                                     kv_mask=jnp.asarray(mask)) ** 2),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (port_fn(*leaves, pmesh, SEQ, kv_mask=torch.from_numpy(mask)) ** 2).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        assert _rel_l2(leaf.grad.numpy(), np.asarray(jg)) <= GRAD_REL_L2, name


def test_ring_on_fewer_devices_and_bf16():
    """A 4-entry ring over N=32, and bf16 inputs: the output keeps q's
    dtype (the accumulators are float32)."""
    pmesh, jmesh = _meshes(4)
    q, k, v = _qkv(5, n=32)
    want = np.asarray(jax_ring(*map(jnp.asarray, (q, k, v)), jmesh, SEQ))
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), pmesh, SEQ)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    bf = ring_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)), pmesh, SEQ)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), want, rtol=0, atol=5e-2)


def test_indivisible_heads_and_sequence_raise():
    pmesh, jmesh = _meshes()
    q, k, v = _qkv(6, h=4)
    with pytest.raises(ValueError, match="divisible"):
        jax_ulysses(*map(jnp.asarray, (q, k, v)), jmesh, SEQ)
    with pytest.raises(ValueError, match="ulysses needs heads"):
        ulysses_attention(*map(torch.from_numpy, (q, k, v)), pmesh, SEQ)
    q, k, v = _qkv(6, n=60)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(*map(torch.from_numpy, (q, k, v)), pmesh, SEQ)


NARROW = dict(vocab_size=40, word_embedding_dim=16, num_heads=8)
L = 64


@pytest.fixture(scope="module")
def text_pair():
    """The dense JAX twin's spec and init, and the port's dense spec."""
    jspec = jax_build_fns(jax_text.long_text_transformer(num_classes=4, **NARROW), (L,),
                          input_dtype=jnp.int32, pad_id=0)
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    r = np.random.RandomState(7)
    x = r.randint(1, 40, (3, L)).astype(np.int32)
    x[0, 40:], x[2, 9:] = 0, 0
    return jparams, x


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_long_text_transformer_matches_jax(text_pair, schedule):
    jparams, x = text_pair
    pmesh, jmesh = _meshes()
    jmodel = jax_text.long_text_transformer(num_classes=4, mesh=jmesh, seq_parallel=schedule,
                                            **NARROW)
    jspec = jax_build_fns(jmodel, (L,), input_dtype=jnp.int32, pad_id=0)
    want = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)))
    model = text.long_text_transformer(num_classes=4, mesh=pmesh, seq_parallel=schedule,
                                       seq_len=L, **NARROW)
    assert model.ring_mesh is pmesh and model.seq_parallel == schedule
    spec = build_fns(model, pad_id=0)
    params = params_from_jax(jparams, spec.layout)
    got = spec.eval_logits_fn(params, torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, **TOL)
    dense = build_fns(text.long_text_transformer(num_classes=4, seq_len=L, **NARROW), pad_id=0)
    np.testing.assert_allclose(
        got, dense.eval_logits_fn(params, torch.from_numpy(x)).detach().numpy(), **TOL)
    # no attention-dropout keep-mask is drawn on the sequence-parallel path
    assert not any(site.endswith("attn.attn") for site in model.noise_sites(2))


def test_unknown_schedule_raises():
    pmesh, _ = _meshes()
    with pytest.raises(ValueError, match="seq_parallel must be"):
        text.long_text_transformer(mesh=pmesh, seq_parallel="tree", seq_len=L, **NARROW)
