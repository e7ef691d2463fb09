"""The port's text models and ``SyntheticText`` against the JAX package's
(``blades_tpu/models/text.py``, ``blades_tpu/datasets/text.py``).

Narrow twins (vocabulary 40, word width 8, encoder width 16, 8 tokens a
row, the grid's depths 2 and 6) take the JAX package's init, carried over
with ``params_from_jax``; the token batches are seeded numpy arrays with
padded rows (``pad_id`` 0), one of them all padding, handed to both.
Tolerances:

- the store, the split and the flat layout: exact;
- the tokenizer's mask and length: exact, over a grid of kernel, stride,
  padding and pooling;
- eval logits, f32: ``rtol=atol=1e-5``;
- the loss and the gradient with attention dropout and DropPath keep-masks
  injected (the JAX side's ``jax.random.bernoulli`` hands out the port's
  masks in flax's draw order): the loss at ``rtol=1e-5``, each leaf of the
  gradient within a relative L2 error of 1e-4, leaf by leaf (plus 1e-7 in
  L2 where the exact gradient is 0: the seq-pool's bias). A max-pool
  window of all-padding positions is a tie of exact zeros, but the ReLU's
  gradient at 0 is 0 in both frameworks, so such ties move nothing;
- bf16 (``compute_dtype``) logits and gradient: relative L2 error at most
  2e-2 (the JAX package adds its float32 sine table to the bf16 stream,
  which promotes its encoder to float32; the port stays in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.datasets import SyntheticText as JaxSyntheticText
from blades_tpu.models import MODELS as JAX_MODELS
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import text as jax_text
from blades_tpu_torch.datasets import SyntheticText
from blades_tpu_torch.models import MODELS, build_fns, create_model, params_from_jax, text
from blades_tpu_torch.ops.pytree import CONV1D, ravel
from blades_tpu_torch.utils import rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

L, VOCAB, CLASSES = 8, 40, 3
NARROW = dict(vocab_size=VOCAB, word_embedding_dim=8, embedding_dim=16)
FAMILIES = ["text_cct_2", "text_cvt_2", "text_vit_2", "text_transformer_2", "text_cct_6",
            "text_cvt_6", "text_vit_6", "text_transformer_6", "long_text_transformer"]
TOL_EVAL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2, GRAD_ATOL, BF16_REL_L2 = 1e-4, 1e-7, 2e-2
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)
# D of every text model at its registry defaults and 64 tokens, by
# jax.eval_shape on the JAX package
FULL_D = {"text_cct_2": 30_352_643, "text_vit_2": 30_352_642,
          "text_transformer_2": 31_085_702, "text_cct_6": 33_466_499,
          "long_text_transformer": 31_085_703}


def _kw(name, **kw):
    out = dict(NARROW)
    if "transformer" in name:  # no tokenizer: the encoder is the word width
        out.pop("embedding_dim")
    return {**out, **kw}


def _pair(name, **kw):
    """(JAX spec, JAX params as numpy, port spec) of a narrow twin."""
    jspec = jax_build_fns(getattr(jax_text, name)(num_classes=CLASSES, **_kw(name, **kw)), (L,),
                          input_dtype=jnp.int32, pad_id=0)
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    spec = build_fns(getattr(text, name)(num_classes=CLASSES, seq_len=L, **_kw(name, **kw)),
                     pad_id=0)
    return jspec, jparams, spec


def _tokens(n, seed=0):
    """Token rows of lengths 5, 0 (all padding), 2, then full ones."""
    r = np.random.RandomState(seed)
    x = r.randint(1, VOCAB, (n, L)).astype(np.int32)
    x[0, 5:], x[1, :], x[2, 2:] = 0, 0, 0
    return x, r.randint(0, CLASSES, n).astype(np.int32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("vocab", [50, 100_000])
@pytest.mark.parametrize("iid", [True, False], ids=["iid", "dirichlet"])
def test_synthetic_text_store_and_split_match_jax(iid, vocab):
    kw = dict(num_clients=5, vocab_size=vocab, seq_len=12, min_len=3, train_size=120,
              test_size=30, iid=iid, alpha=0.5, seed=3, cache=False)
    want, got = JaxSyntheticText(**kw)._partition(), SyntheticText(**kw)._partition()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    fl = SyntheticText(**kw).get_dls("cpu")
    assert fl.train_x.dtype == torch.int32 and fl.pad_id == 0 and fl.sample_shape == (12,)
    assert fl.test_x.dtype == torch.int32  # no normalizer touches the tokens


@pytest.mark.parametrize("max_pool", [True, False], ids=["pool", "nopool"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_tokenizer_mask_and_length_match_jax(k, max_pool):
    r = np.random.RandomState(k)
    mask = np.arange(11)[None, :] < r.randint(0, 12, (6, 1))
    mask[0], mask[1] = False, True
    for stride in (1, 2, 4):
        for padding in (0, 1, 2):
            jtok = jax_text.TextTokenizer(kernel_size=k, stride=stride, padding=padding,
                                          max_pool=max_pool)
            tok = text.TextTokenizer(k, stride, padding, 8, 16, max_pool=max_pool)
            n = tok.seq_len(11)
            assert n == jtok.seq_len(11)
            want = np.asarray(jtok._forward_mask(jnp.asarray(mask)))
            got = tok.forward_mask(torch.from_numpy(mask)).numpy()
            np.testing.assert_array_equal(got, want)
            with torch.no_grad():
                out, _ = tok(torch.randn(6, 11, 8))
            assert out.shape == (6, n, 16)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_match_jax(name):
    jspec, jparams, spec = _pair(name)
    flat = np.asarray(ravel_pytree(jparams)[0])
    jax_order = [tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert [leaf.jax_path for leaf in spec.layout.leaves] == jax_order
    assert spec.layout.dim == spec.param_count == flat.size
    params = params_from_jax(jparams, spec.layout)
    np.testing.assert_array_equal(ravel(params, spec.layout).numpy(), flat)
    x, _ = _tokens(5)
    want = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)))
    got = spec.eval_logits_fn(params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL_EVAL)


def test_flax_names_and_conv1d_layout():
    _, jparams, spec = _pair("text_cct_2")
    paths = {leaf.name: (leaf.jax_path, leaf.perm) for leaf in spec.layout.leaves}
    assert paths["embedder.embedding.weight"] == (("Embedder_0", "Embed_0", "embedding"), ())
    assert paths["tokenizer.conv.weight"] == (("TextTokenizer_0", "Conv_0", "kernel"), CONV1D)
    assert paths["layers.1.self_attn.qkv.weight"][0] == (
        "MaskedTransformerEncoderLayer_1", "MaskedAttention_0", "Dense_0", "kernel")
    assert paths["attention_pool.weight"][0] == ("Dense_0", "kernel")
    assert paths["fc.weight"][0] == ("Dense_1", "kernel")
    params = params_from_jax(jparams, spec.layout)
    kernel = jparams["TextTokenizer_0"]["Conv_0"]["kernel"]  # flax [k, E, C]
    assert kernel.shape == (4, 8, 16) and params["tokenizer.conv.weight"].shape == (16, 8, 4)
    np.testing.assert_array_equal(params["tokenizer.conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    _, jvit, vit = _pair("text_vit_2")
    vit_paths = {leaf.name: leaf.jax_path for leaf in vit.layout.leaves}
    assert vit_paths["fc.weight"] == ("Dense_0", "kernel")
    assert vit_paths["class_emb"] == ("class_emb",) and "class_emb" in jvit


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_registry_param_counts_match_jax_eval_shape(name):
    if not name.startswith(("text_", "long_text")):
        assert name in MODELS
        return
    module = JAX_MODELS[name](num_classes=2)
    shapes = jax.eval_shape(
        lambda k: module.init({"params": k}, jnp.zeros((1, 64), jnp.int32),
                              mask=jnp.ones((1, 64), bool), train=False)["params"],
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = create_model(name, num_classes=2, sample_shape=(64,))
    assert build_fns(model, pad_id=0).param_count == want
    if name in FULL_D:
        assert want == FULL_D[name]


@pytest.mark.parametrize("name", ["text_cct_2", "text_cvt_2", "text_vit_2",
                                  "text_transformer_2", "long_text_transformer"])
def test_all_pad_row_is_finite_and_matches_jax(name):
    """A row of padding alone (an empty client trains on one) has no valid
    key and no valid pooled token: -1e9, not -inf, keeps its logits finite,
    and equal to the JAX package's."""
    jspec, jparams, spec = _pair(name)
    x = np.zeros((2, L), np.int32)
    x[1, :3] = [4, 7, 9]
    want = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)))
    got = spec.eval_logits_fn(params_from_jax(jparams, spec.layout), torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL_EVAL)


@pytest.mark.parametrize("name", ["text_cct_2", "text_vit_2", "text_transformer_2"])
def test_text_mask_invariance(name):
    """Padded positions do not influence the logits when masked
    (``tests/test_models.py::test_text_mask_invariance``)."""
    module = MODELS[name](num_classes=2, sample_shape=(12,), vocab_size=40)
    params = module.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(2, 40, (2, 12), generator=g)
    mask = torch.arange(12)[None, :] < torch.tensor([[7], [12]])  # first row padded
    call = lambda t: torch.func.functional_call(module, params, (t,), {"mask": mask})  # noqa
    with torch.no_grad():
        out1 = call(tokens)
        out2 = call(torch.where(mask, tokens, (tokens * 7 + 3) % 40))
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-5)


def _jax_loss_and_grad(jspec, jparams, x, y):
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jspec.train_loss_fn(p, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1)),
        has_aux=True))(jparams)
    return float(loss), float(aux["top1"]), np.asarray(ravel_pytree(grads)[0])


def _torch_loss_and_grad(spec, params, x, y, noise=None):
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    grads, (loss, aux) = torch.func.grad_and_value(
        lambda p: spec.train_loss_fn(p, xt, yt, noise), has_aux=True)(params)
    return float(loss), float(aux["top1"]), ravel(grads, spec.layout).numpy()


def _assert_leaves_close(spec, grad, jgrad, bar):
    """Each leaf within a relative L2 error of ``bar``, plus GRAD_ATOL in
    L2 for a leaf whose exact gradient is 0 (the seq-pool's bias shifts
    every pooled logit alike, so both frameworks give it rounding alone,
    about 1e-10)."""
    off = 0
    for leaf in spec.layout.leaves:
        g, jg = grad[off:off + leaf.size], jgrad[off:off + leaf.size]
        off += leaf.size
        g, jg = g.astype(np.float64), jg.astype(np.float64)
        err = float(np.linalg.norm(g - jg))
        assert err <= bar * np.linalg.norm(jg) + GRAD_ATOL, (leaf.name, err)


@pytest.mark.parametrize("name", ["text_cct_2", "text_cvt_2", "text_vit_2",
                                  "text_transformer_2", "long_text_transformer"])
def test_grads_match_jax_with_injected_masks(name, monkeypatch):
    jspec, jparams, spec = _pair(name)
    x, y = _tokens(6, seed=1)
    sites = spec.noise_sites(6)
    # attention dropout 0.1 in both layers, DropPath 0.1 in layer 1 only
    n = spec.module.seq_len
    assert list(sites) == ["layers.0.attn.attn", "layers.1.attn.attn", "layers.1.path1",
                           "layers.1.path2"]
    assert sites["layers.0.attn.attn"] == ((6, 2, n, n), 0.9)
    noise = rng.keep_masks(sites, torch.Generator().manual_seed(5))
    noise["layers.1.path2"] = torch.tensor([True, False, True, True, False, True])
    queue = [jnp.asarray(m.numpy()) for m in noise.values()]  # flax's draw order

    def bernoulli(key, p=0.5, shape=None, **kw):
        mask = queue.pop(0)  # DropPath asks for [B, 1, 1], the port's site is [B]
        assert shape[0] == mask.shape[0] and np.prod(shape) == mask.size
        return mask.reshape(shape)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    jloss, jtop1, jgrad = _jax_loss_and_grad(jspec, jparams, x, y)
    assert queue == []
    loss, top1, grad = _torch_loss_and_grad(spec, params_from_jax(jparams, spec.layout), x, y,
                                            noise)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert top1 == jtop1
    _assert_leaves_close(spec, grad, jgrad, GRAD_REL_L2)
    # the word table's gradient is dense in layout but lands only on the
    # rows the batch used (token 0 only through the masked positions: 0)
    at = [leaf.name for leaf in spec.layout.leaves].index("embedder.embedding.weight")
    off = sum(leaf.size for leaf in spec.layout.leaves[:at])
    table = grad[off:off + spec.layout.leaves[at].size].reshape(VOCAB, -1)
    unused = np.setdiff1d(np.arange(VOCAB), x)
    assert not table[unused].any() and not table[0].any()


@pytest.mark.parametrize("name", ["text_cct_2", "text_vit_2", "text_transformer_2"])
def test_bf16_logits_and_grad_match_jax_bf16(name):
    jspec, jparams, _ = _pair(name, **NO_NOISE)
    jspec = jax_build_fns(getattr(jax_text, name)(num_classes=CLASSES, **_kw(name, **NO_NOISE)),
                          (L,), input_dtype=jnp.int32, pad_id=0, compute_dtype=jnp.bfloat16)
    spec = build_fns(getattr(text, name)(num_classes=CLASSES, seq_len=L,
                                         **_kw(name, **NO_NOISE)),
                     compute_dtype=torch.bfloat16, pad_id=0)
    params = params_from_jax(jparams, spec.layout)
    x, y = _tokens(6, seed=2)
    jlogits = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)), np.float32)
    logits = spec.eval_logits_fn(params, torch.from_numpy(x))
    assert logits.dtype == torch.bfloat16
    assert _rel_l2(logits.float().detach().numpy(), jlogits) <= BF16_REL_L2
    jloss, _, jgrad = _jax_loss_and_grad(jspec, jparams, x, y)
    loss, _, grad = _torch_loss_and_grad(spec, params, x, y)
    assert grad.dtype == np.float32
    assert _rel_l2(grad, jgrad) <= BF16_REL_L2
    assert abs(loss - jloss) <= BF16_REL_L2 * abs(jloss)


def test_registry_and_unported_mesh():
    assert {n for n in MODELS if "text" in n} == {n for n in JAX_MODELS if "text" in n}
    assert len([n for n in MODELS if "text" in n]) == 13
    # the sequence-parallel model builds over a mesh (slice 12)
    from blades_tpu_torch.parallel import Mesh

    mesh = Mesh([torch.device("cpu")] * 2, ("seq",))
    assert text.long_text_transformer(mesh=mesh).ring_mesh is mesh
    with pytest.raises(ValueError, match="sample shape"):
        create_model("text_cct_2", sample_shape=(28, 28, 1))
    with pytest.raises(ValueError, match="input length"):
        _, _, spec = _pair("text_cct_2")
        spec.eval_logits_fn(spec.init(torch.Generator().manual_seed(0)),
                            torch.zeros(2, L + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="available"):
        create_model("no_such_model")
