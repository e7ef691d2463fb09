"""Checkpoint import and the pretrained-weight registry of the port
(``models/import_torch.py``, ``models/pretrained.py``, ``utils/fetch.py``)
against the JAX package's (``blades_tpu/models/import_torch.py``,
``pretrained.py``, ``utils/fetch.py``).

No network and no reference checkout: each checkpoint is a reference-named
state dict that the test builds from the JAX package's init of CCT-2 or
ViT-Lite, by the inverse of ``torch_cct_to_flax``'s map (``_reference_sd``,
written here), and hands to both converters. Params are compared exactly
(the same floats, moved); ``resize_pos_embed`` within 1e-6 of the JAX
package's ``jax.image.resize`` on down- and upsampled grids, with and
without a class token (downsampling matches only with ``antialias=True``).
"""

import io
import os

import jax
import numpy as np
import pytest
import torch

from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu.models import create_model as jax_create_model
from blades_tpu.models.import_torch import resize_pos_embed as jax_resize_pos_embed
from blades_tpu.models.import_torch import torch_cct_to_flax
from blades_tpu.utils import fetch as jax_fetch
from blades_tpu_torch.models import build_fns, cct, create_model, params_from_jax, params_to_jax
from blades_tpu_torch.models.import_torch import (
    load_torch_checkpoint,
    resize_pos_embed,
    to_reference_state_dict,
    torch_cct_to_params,
)
from blades_tpu_torch.models.pretrained import weights_path
from blades_tpu_torch.utils.fetch import fetch_to
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

CIFAR = (32, 32, 3)


def _jax_params(factory, shape=CIFAR, **kw):
    spec = jax_build_fns(factory(**kw), shape)
    return jax.tree_util.tree_map(np.asarray, spec.init(jax.random.PRNGKey(0)))


def _reference_sd(tree) -> dict:
    """The reference's state dict of a flax CCT param tree: the inverse of
    ``torch_cct_to_flax``'s map, torch layouts (OIHW convs, ``[out, in]``
    linears)."""
    sd = {}
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    for i, conv in enumerate(sorted(tree.get("Tokenizer_0", {}))):
        node = tree["Tokenizer_0"][conv]
        sd[f"tokenizer.conv_layers.{i}.0.weight"] = t(node["kernel"].transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[f"tokenizer.conv_layers.{i}.0.bias"] = t(node["bias"])
    for top in ("positional_emb", "class_emb"):
        if top in tree:
            sd[f"classifier.{top}"] = t(tree[top])

    def dense(prefix, node):
        sd[f"{prefix}.weight"] = t(node["kernel"].T)
        if "bias" in node:
            sd[f"{prefix}.bias"] = t(node["bias"])

    def norm(prefix, node):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(node["scale"]), t(node["bias"])

    layers = sorted((k for k in tree if k.startswith("TransformerEncoderLayer_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(layers):
        node, blk = tree[name], f"classifier.blocks.{i}"
        norm(f"{blk}.pre_norm", node["LayerNorm_0"])
        norm(f"{blk}.norm1", node["LayerNorm_1"])
        dense(f"{blk}.self_attn.qkv", node["Attention_0"]["Dense_0"])
        dense(f"{blk}.self_attn.proj", node["Attention_0"]["Dense_1"])
        dense(f"{blk}.linear1", node["Dense_0"])
        dense(f"{blk}.linear2", node["Dense_1"])
    norm("classifier.norm", tree["LayerNorm_0"])
    if "Dense_1" in tree:
        dense("classifier.attention_pool", tree["Dense_0"])
        dense("classifier.fc", tree["Dense_1"])
    else:
        dense("classifier.fc", tree["Dense_0"])
    return sd


def _both(name, sd, jtemplate, **kw):
    """The JAX package's and the port's conversion of ``sd``, the port's
    carried to the flax tree for comparison."""
    spec = build_fns(create_model(name, sample_shape=CIFAR))
    template = params_from_jax(jtemplate, spec.layout)
    want = jax.tree_util.tree_map(np.asarray, torch_cct_to_flax(sd, jtemplate, **kw))
    got = torch_cct_to_params(sd, template, **kw)
    return want, params_to_jax(got, spec.layout), got, template


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["cct_2_3x2_32", "vit_lite_7_4_32"])
def test_both_converters_read_a_reference_state_dict_alike(name):
    source = _jax_params(getattr(jax_cct, name), num_classes=10)
    template = jax.tree_util.tree_map(np.zeros_like, source)
    sd = _reference_sd(source)
    want, got, params, _ = _both(name, sd, template)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, source)
    # the port's inverse map gives the reference's names back
    back = to_reference_state_dict(params)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


@pytest.mark.parametrize("grid", ["8to4", "7to5", "4to8", "cls7to9", "cls8to4"])
def test_resize_pos_embed_matches_jax(grid):
    tokens = 1 if grid.startswith("cls") else 0
    old, new = (int(g) for g in grid.removeprefix("cls").split("to"))
    pe = np.random.RandomState(old * 10 + new).randn(1, tokens + old * old, 8)
    pe = pe.astype(np.float32)
    want = jax_resize_pos_embed(pe, tokens + new * new, num_tokens=tokens)
    got = resize_pos_embed(torch.from_numpy(pe), tokens + new * new, num_tokens=tokens)
    assert got.shape == (1, tokens + new * new, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, :tokens].numpy(), pe[:, :tokens])
    if new < old:  # what antialias=True is there for
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(pe[:, tokens:]).reshape(1, old, old, 8).permute(0, 3, 1, 2),
            size=(new, new), mode="bilinear", align_corners=False)
        plain = plain.permute(0, 2, 3, 1).reshape(1, new * new, 8).numpy()
        assert np.abs(plain - want[:, tokens:]).max() > 1e-2
    with pytest.raises(ValueError, match="square"):
        resize_pos_embed(torch.from_numpy(pe), tokens + 10, num_tokens=tokens)


def test_pe_resize_and_its_strict_mode():
    """A checkpoint at 24x24 loads into a 32x32 model by interpolating its
    positional grid (``pe_check``), as the JAX package does; strict mode
    refuses it."""
    sd = _reference_sd(_jax_params(jax_cct.cct_2_3x2_32, (24, 24, 3), num_classes=10,
                                   img_size=24))
    assert sd["classifier.positional_emb"].shape == (1, 36, 128)
    template = _jax_params(jax_cct.cct_2_3x2_32, num_classes=10)
    want, got, _, _ = _both("cct_2_3x2_32", sd, template)
    assert got["positional_emb"].shape == template["positional_emb"].shape == (1, 64, 128)
    np.testing.assert_allclose(got["positional_emb"], want["positional_emb"], rtol=0,
                               atol=1e-6)
    spec = build_fns(cct.cct_2_3x2_32())
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_cct_to_params(sd, params_from_jax(template, spec.layout), pe_resize=False)


def test_fc_tolerant_keeps_the_fresh_head():
    sd = _reference_sd(_jax_params(jax_cct.cct_2_3x2_32, num_classes=100))
    template = _jax_params(jax_cct.cct_2_3x2_32, num_classes=10)
    want, got, params, ttemplate = _both("cct_2_3x2_32", sd, template)
    _assert_trees_equal(got, want)
    assert torch.equal(params["fc.weight"], ttemplate["fc.weight"])
    assert torch.equal(params["tokenizer.convs.0.weight"], sd["tokenizer.conv_layers.0.0.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_cct_to_params(sd, ttemplate, fc_tolerant=False)


def test_sine_model_skips_the_stored_table():
    """The reference's *_sine variants store their table as a parameter; a
    sine model here computes it, so the key is skipped."""
    source = _jax_params(jax_cct.cct_2_3x2_32, num_classes=10, positional_embedding="sine")
    sd = _reference_sd(source)
    sd["classifier.positional_emb"] = torch.zeros(1, 64, 128)
    spec = build_fns(cct.cct_2_3x2_32(positional_embedding="sine"))
    got = torch_cct_to_params(sd, params_from_jax(source, spec.layout))
    _assert_trees_equal(params_to_jax(got, spec.layout), source)


def test_rejects_mismatched_checkpoints():
    """``tests/test_import_torch.py``'s ValueError cases, on the port."""
    spec = build_fns(cct.cct_2_3x2_32(num_classes=10))
    p = spec.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unrecognized state_dict key"):
        torch_cct_to_params({"bogus.key": np.zeros(3)}, p)
    with pytest.raises(ValueError, match="unfilled"):
        torch_cct_to_params({}, p)
    with pytest.raises(ValueError, match="different model variant"):
        torch_cct_to_params({"classifier.blocks.5.pre_norm.weight": np.zeros(128)}, p)
    with pytest.raises(ValueError, match="unrecognized state_dict key"):
        torch_cct_to_params({"epoch": np.zeros(1)}, p)
    with pytest.raises(ValueError, match="unrecognized block entry"):
        torch_cct_to_params({"classifier.blocks.0.mlp.weight": np.zeros(1)}, p)


def test_create_model_pretrained_loads_the_cached_checkpoint(tmp_path, monkeypatch):
    """``create_model(..., pretrained=True)`` loads from the local cache with
    no network touch, equal to the JAX package's load of the same file; an
    offline miss and an unregistered name raise."""
    monkeypatch.setenv("BLADES_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("BLADES_TPU_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="BLADES_TPU_OFFLINE"):
        create_model("cct_7_3x1_32", sample_shape=CIFAR, pretrained=True).init(
            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="available"):
        create_model("cct_2_3x2_32", sample_shape=CIFAR, pretrained=True).init(
            torch.Generator().manual_seed(0))
    source = _jax_params(jax_cct.cct_7_3x1_32, num_classes=10)
    path = weights_path("cct_7_3x1_32")
    assert path == os.path.join(str(tmp_path), "cct_7_3x1_32_cifar10_300epochs.pth")
    torch.save({"state_dict": _reference_sd(source)}, path)

    spec = create_model("cct_7_3x1_32", sample_shape=CIFAR, pretrained=True)
    params = spec.init(torch.Generator().manual_seed(0))
    jspec = jax_create_model("cct_7_3x1_32", pretrained=True)
    want = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    _assert_trees_equal(params_to_jax(params, spec.layout), want)
    _assert_trees_equal(want, source)
    x = np.random.RandomState(1).randn(2, *CIFAR).astype(np.float32)
    logits = spec.eval_logits_fn(params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(logits, np.asarray(jspec.eval_logits_fn(want, x)),
                               rtol=1e-5, atol=1e-5)
    # another registry entry for the same architecture, at 100 classes
    # (fc_check keeps the fresh head of the 100-class template)
    torch.save(_reference_sd(source), weights_path("cct_7_3x1_32_c100"))
    c100 = create_model("cct_7_3x1_32", num_classes=100, sample_shape=CIFAR,
                        pretrained="cct_7_3x1_32_c100")
    fresh = c100.init(torch.Generator().manual_seed(0))
    assert fresh["fc.weight"].shape == (100, 256)
    assert torch.equal(fresh["norm.weight"], params["norm.weight"])
    loaded = load_torch_checkpoint(path, params)
    assert all(torch.equal(loaded[n], params[n]) for n in params)


class _Broken(io.BytesIO):
    def read(self, *a):
        raise OSError("connection reset")


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_fetch_to_is_atomic_and_cleans_up(tmp_path, monkeypatch, impl):
    fetch = fetch_to if impl == "port" else jax_fetch.fetch_to
    monkeypatch.delenv("BLADES_TPU_OFFLINE", raising=False)
    dest = tmp_path / "sub" / "w.pth"
    payload = os.urandom(100_000)
    assert fetch(str(dest), lambda: io.BytesIO(payload), "w") == str(dest)
    assert dest.read_bytes() == payload and not (tmp_path / "sub" / "w.pth.part").exists()
    bad = tmp_path / "bad.pth"
    with pytest.raises(RuntimeError, match="place the file at") as err:
        fetch(str(bad), lambda: _Broken(b"x"), "bad weights")
    assert "OSError: connection reset" in str(err.value)
    assert not bad.exists() and not (tmp_path / "bad.pth.part").exists()
    monkeypatch.setenv("BLADES_TPU_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="BLADES_TPU_OFFLINE=1") as err:
        fetch(str(bad), lambda: io.BytesIO(payload), "bad weights")
    assert str(bad) in str(err.value)
