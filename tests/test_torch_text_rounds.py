"""Rounds of the port's text models.

- A K=5 round of the narrow ``text_cct_2`` twin (vocabulary 40, word width
  8, encoder width 16, 8 tokens a row) under ALIE (f=2) and trimmed mean
  (b=2) against ``blades_tpu.core.RoundEngine``: the update matrix, the new
  params and the metrics within ``rtol=1e-4, atol=1e-5`` (the rounds' bar
  of ``tests/test_torch_engine.py``). Attention dropout and DropPath are
  off on both sides, so nothing is drawn in training; the token batches are
  seeded numpy arrays with padded rows, handed to both.
- The twin's streaming round with the mean equals its dense round (f32
  ``rtol=1e-5, atol=1e-6``, as ``tests/test_torch_streaming_rounds.py``
  holds the exact forms), with the model's keep-masks drawn.
- ``Simulator(SyntheticText(...), device="cpu").run("text_cct_2")`` at the
  registry's full width, the counterpart of
  ``tests/test_simulator.py::test_text_model_end_to_end``.
- A text round in a subprocess loads no ``jax``.
- On the card (``cuda`` marker, skipped here): the twin's round under ALIE
  and trimmed mean on the card against the CPU, the kernel launching once.

The JAX package is imported inside the test that compares with it, so that
on the card the file runs as ``python -m pytest --noconftest -m cuda
tests/test_torch_text_rounds.py`` without flax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.core import RoundEngine, RoundMetrics
from blades_tpu_torch.models import build_fns, text
from blades_tpu_torch.ops.pytree import ravel
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)
K, F, S, B, L, VOCAB, CLASSES = 5, 2, 2, 4, 8, 40, 3
CLIENT_LR, SERVER_LR = 0.3, 1.0
NARROW = dict(num_classes=CLASSES, vocab_size=VOCAB, word_embedding_dim=8, embedding_dim=16)
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


def _batches(k, seed=300):
    """``[K, S, B, L]`` token rows, the first two of each step padded (one
    of them whole), and ``[K, S, B]`` labels."""
    r = np.random.RandomState(seed)
    cx = r.randint(1, VOCAB, (k, S, B, L)).astype(np.int32)
    cx[:, :, 0, 5:] = 0
    cx[:, :, 1, :] = 0
    return cx, r.randint(0, CLASSES, (k, S, B)).astype(np.int32)


def _engine(spec, params, device="cpu", k=K, **kw):
    return RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                       num_clients=k, num_byzantine=F,
                       attack=get_attack("alie", num_clients=k, num_byzantine=F),
                       aggregator=get_aggregator("trimmedmean", num_byzantine=F),
                       device=device, noise_sites=spec.noise_sites, **kw)


@pytest.mark.filterwarnings(
    "error:.*performance drop because we have not yet implemented the batching rule")
def test_text_round_matches_jax():
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
    from blades_tpu.attackers import get_attack as jax_get_attack
    from blades_tpu.core import RoundEngine as JaxRoundEngine
    from blades_tpu.models import build_fns as jax_build_fns
    from blades_tpu.models import text as jax_text
    from blades_tpu_torch.models import params_from_jax

    jspec = jax_build_fns(jax_text.text_cct_2(**NARROW, **NO_NOISE), (L,),
                          input_dtype=jnp.int32, pad_id=0)
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    spec = build_fns(text.text_cct_2(seq_len=L, **NARROW, **NO_NOISE), pad_id=0)
    params = params_from_jax(jparams, spec.layout)
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=K, num_byzantine=F,
        attack=jax_get_attack("alie", num_clients=K, num_byzantine=F),
        aggregator=jax_get_aggregator("trimmedmean", num_byzantine=F), plan=None,
        keep_updates=True,
    )
    teng = _engine(spec, params)
    cx, cy = _batches(K)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(params), torch.from_numpy(cx), torch.from_numpy(cy),
                                CLIENT_LR, SERVER_LR)
    assert teng.last_updates.shape == (K, spec.param_count)
    np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates), **TOL)
    np.testing.assert_allclose(ravel(tstate.params, spec.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **TOL)
    for field in RoundMetrics._fields:
        atol = 1e-12 if field.startswith("update_variance") else TOL["atol"]
        np.testing.assert_allclose(float(getattr(tm, field)), float(getattr(jm, field)),
                                   rtol=TOL["rtol"], atol=atol, err_msg=field)


def test_text_streaming_mean_round_equals_dense_round():
    spec = build_fns(text.text_cct_2(seq_len=L, **NARROW), pad_id=0)
    params = spec.init(torch.Generator().manual_seed(4))
    out = {}
    for streaming in (True, False):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=6, num_byzantine=F, attack=get_attack("signflipping"),
                          aggregator=get_aggregator("mean"), device="cpu",
                          noise_sites=spec.noise_sites, client_chunks=3, streaming=streaming)
        assert eng.streaming == streaming
        state = eng.init(params)
        ms = []
        for rnd in range(2):
            cx, cy = (torch.from_numpy(a) for a in _batches(6, seed=rnd))
            state, m = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR, seed=9)
            ms.append(m)
        out[streaming] = (ravel(state.params, spec.layout), ms)
    torch.testing.assert_close(out[True][0], out[False][0], **EXACT_TOL)
    for ms, md in zip(out[True][1], out[False][1]):
        assert float(ms.train_loss) == pytest.approx(float(md.train_loss), rel=1e-6)
        assert float(ms.agg_norm) == pytest.approx(float(md.agg_norm), rel=1e-5)


def test_text_model_end_to_end(tmp_path):
    """The text family through the whole facade at the registry's width
    (a 100,000-word table): token store -> masked text model -> attack ->
    aggregation (``tests/test_simulator.py::test_text_model_end_to_end``)."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import SyntheticText

    ds = SyntheticText(num_clients=4, vocab_size=80, seq_len=8, train_size=200, test_size=60,
                       cache=False)
    sim = Simulator(ds, log_path=str(tmp_path / "out"), seed=0, num_byzantine=1,
                    attack="signflipping", aggregator="median", device="cpu")
    sim.run("text_cct_2", global_rounds=4, local_steps=2, client_lr=0.3, server_lr=1.0,
            validate_interval=4, train_batch_size=16)
    assert sim.engine.dim == 30_000_000 + 4 * 300 * 128 + 198_400 + 256 + 129 + 258
    assert sim.dataset.train_x.dtype == torch.int32
    ev = sim.evaluate(4, 64)
    assert np.isfinite(ev["Loss"])
    # class-conditional unigrams are separable: must beat chance quickly
    assert ev["top1"] > 0.4


def test_text_round_in_subprocess_loads_no_jax(tmp_path):
    forbidden = ("jax", "jaxlib", "flax", "optax", "blades_tpu")
    code = (
        "import sys\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import SyntheticText\n"
        "from blades_tpu_torch.models import text\n"
        "ds = SyntheticText(num_clients=6, vocab_size=40, seq_len=8, train_size=120,\n"
        "                   test_size=30, cache=False)\n"
        "sim = Simulator(ds, attack='alie', num_byzantine=2, aggregator='trimmedmean',\n"
        f"                device='cpu', log_path={str(tmp_path / 'out')!r})\n"
        "model = text.text_cct_2(num_classes=2, seq_len=8, vocab_size=40,\n"
        "                        word_embedding_dim=8, embedding_dim=16)\n"
        "sim.run(model=model, global_rounds=1, train_batch_size=4)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{forbidden!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trimmed-mean kernel and the card's text round")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.filterwarnings(
    "error:.*performance drop because we have not yet implemented the batching rule")
def test_card_text_round_matches_cpu(card, monkeypatch):
    from blades_tpu_torch.ops import trimmed

    # the same f32 math on both backends: no TF32 in the card's conv
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    spec = build_fns(text.text_cct_2(seq_len=L, **NARROW, **NO_NOISE), pad_id=0)
    params = spec.init(torch.Generator().manual_seed(4))
    cx, cy = (torch.from_numpy(a) for a in _batches(K))
    out = {}
    for dev in ("cpu", card):
        eng = _engine(spec, params, dev)
        trimmed.trimmed_mean_launches = 0
        state, _ = eng.run_round(eng.init(params), cx.to(dev), cy.to(dev), CLIENT_LR,
                                 SERVER_LR)
        out[str(dev)] = (eng.last_updates.cpu(), ravel(state.params, spec.layout).cpu(),
                         trimmed.trimmed_mean_launches)
    (u_cpu, p_cpu, _), (u_gpu, p_gpu, launches) = out["cpu"], out[str(card)]
    assert launches == 1
    torch.testing.assert_close(u_gpu, u_cpu, **TOL)
    torch.testing.assert_close(p_gpu, p_cpu, **TOL)
