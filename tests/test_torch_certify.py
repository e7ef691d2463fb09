"""The defense certification path (``audit/attack_search.py``,
``audit/contracts.py``, ``sweeps.run_grouped``, ``examples/certify.py``)
against the JAX package's.

The random inputs are drawn once on the JAX side and handed to the port:
the honest trials of ``synthetic_honest``, the battery's permutation and
translation (through ``contracts.battery_draws`` and the certify script's
``sweep_inputs``). DnC draws its subspaces in the port from the context's
generator; those draws are handed to the JAX package's DnC, keyed by the
JAX key that stands for that generator, with its loops run eagerly
(``jax.disable_jit``) so each iteration takes its own draw, as
``tests/test_torch_aggregators.py`` does.

Templates at ``rtol = atol = 1e-5``; search deviations and ratios at
``rtol=1e-4, atol=1e-6``; verdicts (certified, each contract's ``ok``)
exactly. The whole quick matrix of both certify scripts is built once per
module.
"""

import argparse
import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu import audit as jaudit
from blades_tpu.aggregators import AGGREGATORS as JAX_AGGREGATORS
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.aggregators.dnc import Dnc as JaxDnc
from blades_tpu.audit import attack_search as jsearch
from blades_tpu.sweeps import SweepCell as JaxSweepCell
from blades_tpu.sweeps import plan_groups as jax_plan_groups
from blades_tpu_torch import audit
from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.audit import attack_search, contracts
from blades_tpu_torch.examples import certify
from blades_tpu_torch.sweeps import SweepCell, group_key, plan_groups, run_grouped
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import certify as jax_certify  # noqa: E402  (scripts/certify.py)

TEMPLATE_TOL = dict(rtol=1e-5, atol=1e-5)
SEARCH_TOL = dict(rtol=1e-4, atol=1e-6)
K, D, T = 8, 32, 3
# the generators that stand for the JAX context keys in the port
SWEEP_GEN_SEED, BATTERY_GEN_SEED = 101, 202


# -- handing the JAX draws to the port and the port's DnC draws to JAX ----------


def _key_bytes(key) -> bytes:
    return np.asarray(key).astype(np.uint32).tobytes()


def _jax_sweep_inputs(seed, trials, k, d):
    key = jax.random.PRNGKey(seed)
    return (jaudit.synthetic_honest(key, trials, k, d),
            jax.random.fold_in(key, 1))


def _jax_battery_draws(seed, trials, k, d):
    key = jax.random.PRNGKey(seed)
    k_data, k_perm, k_trans, k_ctx = jax.random.split(key, 4)
    return {
        "trials": jaudit.synthetic_honest(k_data, trials, k, d),
        "perm": jax.random.permutation(k_perm, k),
        "shift": 3.0 * jax.random.normal(k_trans, (d,), jnp.float32) / np.sqrt(d),
        "key": k_ctx,
    }


class DrawBook:
    """JAX key -> the port generator that stands for it; patches the port to
    take the JAX draws and the JAX DnC to take the port's subspaces."""

    def __init__(self, monkeypatch, seed, trials, k, d):
        self.by_key = {}
        self.k, self.d = k, d
        sweep_trials, sweep_key = _jax_sweep_inputs(seed, trials, k, d)
        bat = _jax_battery_draws(seed, trials, k, d)
        self.by_key[_key_bytes(sweep_key)] = SWEEP_GEN_SEED
        self.by_key[_key_bytes(bat["key"])] = BATTERY_GEN_SEED

        def sweep_inputs(seed_, trials_, k_, d_, device="cpu"):
            assert (seed_, trials_, k_, d_) == (seed, trials, k, d)
            ctx = contracts.battery_ctx(None, k, d, device=device,
                                        generator=torch.Generator().manual_seed(SWEEP_GEN_SEED))
            return torch.from_numpy(np.asarray(sweep_trials)).to(device), ctx

        def battery_draws(seed_, trials_, k_, d_):
            assert (seed_, trials_, k_, d_) == (seed, trials, k, d)
            return {
                "trials": torch.from_numpy(np.asarray(bat["trials"])),
                "perm": torch.from_numpy(np.asarray(bat["perm"]).astype(np.int64)),
                "shift": torch.from_numpy(np.asarray(bat["shift"])),
                "generator": torch.Generator().manual_seed(BATTERY_GEN_SEED),
            }

        monkeypatch.setattr(certify, "sweep_inputs", sweep_inputs)
        monkeypatch.setattr(contracts, "battery_draws", battery_draws)
        self._patch_jax_dnc(monkeypatch)

    def _patch_jax_dnc(self, monkeypatch):
        orig = JaxDnc._aggregate_impl
        book = self

        def impl(dnc, updates, state, key, mask):
            gen_seed = book.by_key[_key_bytes(key)]
            sub_dim = min(dnc.sub_dim, updates.shape[1])
            draws = draw_subspaces(torch.Generator().manual_seed(gen_seed), dnc.num_iters,
                                   updates.shape[1], sub_dim, "cpu")
            queue = [t.numpy() for pair in draws for t in pair]

            def take(kind):
                def fn(key, *args, **kwargs):
                    arr = queue.pop(0)
                    assert (kind == "choice") == (arr.dtype == np.int64), kind
                    return jnp.asarray(arr.astype(np.int32) if kind == "choice" else arr)
                return fn

            with monkeypatch.context() as m:
                m.setattr(jax.random, "choice", take("choice"))
                m.setattr(jax.random, "normal", take("normal"))
                out = orig(dnc, updates, state, key, mask)
            assert queue == []
            return out

        monkeypatch.setattr(JaxDnc, "_aggregate_impl", impl)


def _args(**kw):
    base = dict(clients=K, dim=D, trials=T, seed=0, c=None, aggs=None, quick=True,
                no_async=False, tau_max=3, no_jit=False, sequential=False, out="unused",
                attempts=2, cell_deadline=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _jax_matrix(args):
    plans, specs = jax_certify.enumerate_cells(args)
    results, walls, report = jax_certify.execute_cells(args, plans, specs)
    matrix = jax_certify.assemble_matrix(args, plans, specs, results, walls, report)
    return [s.label for s in specs], results, matrix


def _port_matrix(args):
    plans, specs = certify.enumerate_cells(args, "cpu")
    results, walls, report = certify.execute_cells(args, plans, specs)
    matrix = certify.assemble_matrix(args, plans, specs, results, walls, report, "cpu")
    return [s.label for s in specs], results, matrix


@pytest.fixture(scope="module")
def quick_matrices():
    """Both certify scripts' quick matrices over the whole pool with the async
    columns, on the same draws; JAX's DnC cells run eagerly on the port's
    subspaces."""
    mp = pytest.MonkeyPatch()
    try:
        DrawBook(mp, 0, T, K, D)
        others = [n for n in certify.CERT_POOL if n != "dnc"]
        jax_labels, jax_results, jax_m = _jax_matrix(_args(aggs=others))
        with jax.disable_jit():
            dnc_labels, dnc_results, dnc_m = _jax_matrix(_args(aggs=["dnc"]))
        port = _port_matrix(_args())
    finally:
        mp.undo()
    jax_by = dict(zip(jax_labels + dnc_labels, jax_results + dnc_results))
    jax_rows = {}
    for m in (jax_m, dnc_m):
        for row in m["cells"]:
            jax_rows[(row["agg"], row["f"], None)] = row
        for row in m["async_cells"]:
            jax_rows[(row["agg"], row["f"], row["scenario"])] = row
    jax_battery = {**jax_m["battery"], **dnc_m["battery"]}
    return {"jax": (jax_by, jax_rows, jax_battery), "port": port,
            "jax_ok": (jax_m["ok"], dnc_m["ok"])}


def _assert_search(got, want, label=""):
    np.testing.assert_allclose(got["worst_ratio"], want["worst_ratio"], err_msg=label,
                               **SEARCH_TOL)
    np.testing.assert_allclose(got["worst_dev"], want["worst_dev"], err_msg=label, **SEARCH_TOL)
    np.testing.assert_allclose(got["rho"], want["rho"], err_msg=label, **SEARCH_TOL)
    for t in jsearch.TEMPLATE_NAMES:
        for field in ("worst_dev", "worst_ratio"):
            np.testing.assert_allclose(got["templates"][t][field], want["templates"][t][field],
                                       err_msg=f"{label} {t} {field}", **SEARCH_TOL)


# -- the whole quick matrix, one case per defense --------------------------------


@pytest.mark.parametrize("name", certify.CERT_POOL)
def test_quick_matrix_matches_jax(quick_matrices, name):
    jax_by, jax_rows, jax_battery = quick_matrices["jax"]
    labels, results, matrix = quick_matrices["port"]
    mine = [(lab, r) for lab, r in zip(labels, results)
            if lab == f"battery/{name}" or lab.split("/")[0] == name]
    assert len(mine) == 1 + 4 * 3
    for lab, r in mine:
        _assert_search(r, jax_by[lab], lab)
    rows = [r for r in matrix["cells"] if r["agg"] == name]
    rows += [r for r in matrix["async_cells"] if r["agg"] == name]
    for row in rows:
        want = jax_rows[(row["agg"], row["f"], row.get("scenario"))]
        assert row["certified"] == want["certified"], (name, row["f"], row.get("scenario"))
        assert row.get("staleness") == want.get("staleness")
    got_bat, want_bat = matrix["battery"][name], jax_battery[name]
    assert got_bat["nominal_f"] == want_bat["nominal_f"]
    for cname, r in want_bat["contracts"].items():
        assert got_bat["contracts"][cname]["ok"] == r["ok"], (name, cname)
        assert got_bat["contracts"][cname]["optout"] == r["optout"], (name, cname)


def test_quick_matrix_headline_ok_in_both(quick_matrices):
    _, _, matrix = quick_matrices["port"]
    assert matrix["ok"] and matrix["headline_failures"] == []
    assert quick_matrices["jax_ok"] == (True, True)
    assert len(matrix["cells"]) == 16 * 4 and len(matrix["async_cells"]) == 16 * 4 * 2


# -- each template alone --------------------------------------------------------


def _template_inputs(seed, masked):
    r = np.random.RandomState(seed)
    u = r.randn(K, D).astype(np.float32)
    u[:3] = u[0]  # ALIE-style tied byzantine rows
    byz = np.arange(K) < 3
    part = None
    if masked:
        part = np.ones(K, bool)
        part[[3, 6]] = False
    return u, byz, part


def _both(u, byz, part):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (t(u), t(byz), t(part)), (j(u), j(byz), j(part))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("template,param", [
    ("ipm_rows", 100.0), ("ipm_rows", 0.5), ("alie_rows", 1.5), ("alie_rows", 4.0),
    ("signflip_rows", 10.0)])
def test_scalar_template_matches_jax(template, param, masked):
    (tu, tb, tp), (ju, jb, jp) = _both(*_template_inputs(3, masked))
    got = getattr(attack_search, template)(tu, tb, torch.tensor(param), tp)
    want = getattr(jsearch, template)(ju, jb, jnp.float32(param), jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TEMPLATE_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("template", ["minmax_rows", "minsum_rows"])
@pytest.mark.parametrize("direction", [0, 1, 2])
def test_envelope_template_matches_jax(template, direction, masked):
    """Min-Max and Min-Sum on each direction of ``dev_directions``,
    the bisected gamma included (the rows hold ``mu + gamma * dev``)."""
    (tu, tb, tp), (ju, jb, jp) = _both(*_template_inputs(5, masked))
    tdev = attack_search.dev_directions(tu, tb, tp)
    jdev = jsearch.dev_directions(ju, jb, jp)
    np.testing.assert_allclose(tdev.numpy(), np.asarray(jdev), **TEMPLATE_TOL)
    got = getattr(attack_search, template)(tu, tb, tdev[direction], tp, n_bisect=20)
    want = getattr(jsearch, template)(ju, jb, jdev[direction], jp, n_bisect=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TEMPLATE_TOL)
    rho_t = attack_search.honest_reference(tu, tb, tp)[1]
    rho_j = jsearch.honest_reference(ju, jb, jp)[1]
    np.testing.assert_allclose(float(rho_t), float(rho_j), **TEMPLATE_TOL)


def test_bisection_is_a_fixed_loop_on_the_device():
    """The bisection is a loop of fixed count whose feasibility test gets a
    0-d tensor and returns one (no host read), with JAX's result."""
    seen = []

    def feasible(gamma):
        assert isinstance(gamma, torch.Tensor) and gamma.dim() == 0
        seen.append(1)
        return gamma < 3.0

    like = torch.zeros(2)
    g = attack_search._bisect_gamma(feasible, 10.0, 20, like)
    jg = jsearch._bisect_gamma(lambda x: x < 3.0, 10.0, 20, jnp.float32)
    assert len(seen) == 20
    np.testing.assert_allclose(float(g), float(jg), **TEMPLATE_TOL)
    # never feasible: gamma walks down to 10 / 2**20, as in JAX
    low = attack_search._bisect_gamma(lambda x: x < -1.0, 10.0, 20, like)
    jlow = jsearch._bisect_gamma(lambda x: x < -1.0, 10.0, 20, jnp.float32)
    assert float(low) == float(jlow) > 0.0


# -- search_cell per defense, default grids --------------------------------------


@pytest.mark.parametrize("name", certify.CERT_POOL)
def test_search_cell_default_grids_matches_jax(monkeypatch, name):
    book = DrawBook(monkeypatch, 0, 2, K, D)
    jtrials, jkey = _jax_sweep_inputs(0, 2, K, D)
    f = 2
    pctx = contracts.battery_ctx(None, K, D,
                                 generator=torch.Generator().manual_seed(SWEEP_GEN_SEED))
    jctx = jaudit.battery_ctx(None, K, D, key=jkey)
    assert _key_bytes(jkey) in book.by_key
    got = audit.search_cell(certify.build_aggregator(name, K, f),
                            torch.from_numpy(np.asarray(jtrials)), f, ctx=pctx,
                            grids=audit.DEFAULT_GRIDS)
    ctx = jax.disable_jit() if name == "dnc" else contextlib.nullcontext()
    with ctx:
        want = jaudit.search_cell(jax_certify.build_aggregator(name, K, f), jtrials, f,
                                  ctx=jctx, grids=jaudit.DEFAULT_GRIDS,
                                  use_jit=name != "dnc")
    _assert_search(got, want, name)
    assert (got["worst_ratio"] <= audit.DEFAULT_C) == (want["worst_ratio"] <= jaudit.DEFAULT_C)


def test_search_cell_staleness_matches_jax():
    jtrials, jkey = _jax_sweep_inputs(1, 2, K, D)
    ptrials = torch.from_numpy(np.asarray(jtrials))
    for tau_byz, cutoff, mode in ((0, None, "polynomial"), (3, None, "polynomial"),
                                  (0, 1, "cutoff")):
        got = audit.search_cell_staleness(
            get_aggregator("median"), ptrials, 2, mode=mode, tau_byz=tau_byz, cutoff=cutoff,
            ctx=contracts.battery_ctx(None, K, D), grids=audit.QUICK_GRIDS)
        want = jaudit.search_cell_staleness(
            jax_get_aggregator("median"), jtrials, 2, mode=mode, tau_byz=tau_byz,
            cutoff=cutoff, ctx=jaudit.battery_ctx(None, K, D, key=jkey),
            grids=jaudit.QUICK_GRIDS, use_jit=True)
        _assert_search(got, want, f"tau{tau_byz}")
        assert got["staleness"].keys() == want["staleness"].keys()
        for field, v in want["staleness"].items():
            if isinstance(v, float):
                np.testing.assert_allclose(got["staleness"][field], v, **TEMPLATE_TOL)
            else:
                assert got["staleness"][field] == v, field
        mask, w, tau = audit.staleness_row_weights(K, 2, mode=mode, tau_byz=tau_byz,
                                                   cutoff=cutoff)
        jmask, jw, jtau = jaudit.staleness_row_weights(K, 2, mode=mode, tau_byz=tau_byz,
                                                       cutoff=cutoff)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TEMPLATE_TOL)


# -- the contract battery and the opt-outs ----------------------------------------


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_run_battery_verdicts_match_jax(monkeypatch, name):
    DrawBook(monkeypatch, 0, 1, K, 16)
    kw = contracts.battery_kwargs(name, K, max(1, contracts.nominal_f(name, K)))
    got = audit.run_battery(get_aggregator(name, **kw), k=K, d=16, name=name)
    ctx = jax.disable_jit() if name == "dnc" else contextlib.nullcontext()
    with ctx:
        want = jaudit.run_battery(jax_get_aggregator(name, **kw), k=K, d=16, name=name,
                                  use_jit=name != "dnc")
    assert sorted(got) == sorted(want) == sorted(audit.CONTRACTS)
    for cname in audit.CONTRACTS:
        assert got[cname]["ok"] == want[cname]["ok"], (name, cname, got[cname], want[cname])
    np.testing.assert_allclose(got["resilience"]["worst_ratio"],
                               want["resilience"]["worst_ratio"], **SEARCH_TOL)
    # every failure is declared, as the JAX registry lint asks
    agg = get_aggregator(name, **kw)
    for cname, r in got.items():
        assert r["ok"] or cname in agg.audit_optouts, (name, cname)


@pytest.mark.parametrize("name,kw", [(n, {}) for n in sorted(AGGREGATORS)]
                         + [("clustering", {"metric": "distance"})])
def test_audit_optouts_equal_jax(name, kw):
    got = get_aggregator(name, **kw).audit_optouts
    want = jax_get_aggregator(name, **kw).audit_optouts
    assert dict(got) == dict(want)
    assert set(got) <= set(audit.CONTRACTS)
    assert sorted(AGGREGATORS) == sorted(JAX_AGGREGATORS)


def test_contract_checks_hand_each_call_the_same_draws():
    """A random defense sees the same subspaces for ``u`` and ``P u``: each
    call gets a generator at the context generator's state, so DnC's
    permutation check measures the permutation, not two draws."""
    u = torch.from_numpy(np.random.RandomState(0).randn(K, D).astype(np.float32))
    ctx = contracts.battery_ctx(None, K, D, generator=torch.Generator().manual_seed(3))
    state = ctx["generator"].get_state()
    res = contracts.check_permutation(get_aggregator("dnc", num_byzantine=2, sub_dim=8), u, ctx)
    assert res["ok"], res
    assert torch.equal(ctx["generator"].get_state(), state)  # never advanced


def test_battery_ctx_and_nominal_f_match_jax():
    for name in sorted(AGGREGATORS):
        for k in (4, 8, 11):
            assert contracts.nominal_f(name, k) == jaudit.nominal_f(name, k)
            for f in range(k // 2):
                assert contracts.battery_kwargs(name, k, f) == jaudit.battery_kwargs(name, k, f)
    ctx = contracts.battery_ctx(None, K, D)
    jctx = jaudit.battery_ctx(None, K, D)
    np.testing.assert_array_equal(ctx["trusted_mask"].numpy(), np.asarray(jctx["trusted_mask"]))
    np.testing.assert_array_equal(ctx["params_flat"].numpy(), np.asarray(jctx["params_flat"]))
    assert isinstance(ctx["generator"], torch.Generator)
    assert ctx["generator"].device.type == "cpu"


# -- sweeps: grouping and batched == sequential -----------------------------------


@pytest.fixture(scope="module")
def sweep_inputs():
    tr = jaudit.synthetic_honest(jax.random.PRNGKey(0), 2, 6, 8)
    small = jaudit.synthetic_honest(jax.random.PRNGKey(1), 2, 4, 8)
    return tr, small


def test_search_cells_bit_identical_to_search_cell(sweep_inputs):
    tr = torch.from_numpy(np.asarray(sweep_inputs[0]))
    ctx = contracts.battery_ctx(None, 6, 8)
    for name, kw in (("median", {}), ("trimmedmean", {"num_byzantine": 1}),
                     ("dnc", {"num_byzantine": 1, "sub_dim": 4})):
        agg = get_aggregator(name, **kw)
        cells = [dict(trials=tr, f=f, ctx=ctx, part_mask=None, label=f"f{f}") for f in range(3)]
        batched = audit.search_cells(agg, cells, grids=audit.QUICK_GRIDS)
        for f in range(3):
            assert batched[f] == audit.search_cell(agg, tr, f, ctx=ctx, grids=audit.QUICK_GRIDS)


def test_run_grouped_input_order_and_walls(sweep_inputs):
    tr = torch.from_numpy(np.asarray(sweep_inputs[0]))
    ctx = contracts.battery_ctx(None, 6, 8)
    cells = [
        SweepCell("m/f1", get_aggregator("median"), tr, 1, ctx),
        SweepCell("tm/f1", get_aggregator("trimmedmean", num_byzantine=1), tr, 1, ctx),
        SweepCell("m/f2", get_aggregator("median"), tr, 2, ctx),
    ]
    results, walls = run_grouped(cells, grids=audit.QUICK_GRIDS, return_walls=True)
    assert results[0] == audit.search_cell(cells[0].agg, tr, 1, ctx=ctx, grids=audit.QUICK_GRIDS)
    assert results[2] == audit.search_cell(cells[2].agg, tr, 2, ctx=ctx, grids=audit.QUICK_GRIDS)
    assert all(w > 0 for w in walls) and walls[0] == walls[2]
    with pytest.raises(ValueError, match="trial shape"):
        audit.search_cells(get_aggregator("median"), [
            dict(trials=tr, f=1, ctx=ctx, part_mask=None, label="a"),
            dict(trials=tr[:, :4], f=1, ctx=ctx, part_mask=None, label="b")])
    with pytest.raises(ValueError, match="part-mask"):
        audit.search_cells(get_aggregator("median"), [
            dict(trials=tr, f=1, ctx=ctx, part_mask=None, label="a"),
            dict(trials=tr, f=1, ctx=ctx, part_mask=torch.ones(6, dtype=torch.bool),
                 label="b")])


def test_certify_sequential_is_one_group_a_cell(monkeypatch):
    """``--sequential`` runs each cell as a group of its own (through the
    per-cell resilient loop) and gives the grouped run's numbers."""
    args = _args(aggs=["mean", "trimmedmean", "krum", "centeredclipping"], trials=2)
    plans, specs = certify.enumerate_cells(args, "cpu")
    grouped, _, _ = certify.execute_cells(args, plans, specs)
    assert grouped == run_grouped(specs, grids=audit.QUICK_GRIDS)
    sizes = []
    execute = certify._execute_group

    def counted(cells, key, **kw):
        sizes.append(len(cells))
        return execute(cells, key, **kw)

    monkeypatch.setattr(certify, "_execute_group", counted)
    sequential, walls, report = certify.execute_cells(argparse.Namespace(**{
        **vars(args), "sequential": True}), plans, specs)
    assert sizes == [1] * len(specs)
    assert sequential == grouped and len(walls) == len(specs)
    assert report.executed == len(specs) and report.retried == 0


def _cells(mk, get, tr, small, ctx, small_ctx, ones):
    return [
        mk("tm1/f1", get("trimmedmean", num_byzantine=1), tr, 1, ctx),
        mk("tm1/f2", get("trimmedmean", num_byzantine=1), tr, 2, ctx),
        mk("tm2", get("trimmedmean", num_byzantine=2), tr, 2, ctx),
        mk("k4", get("trimmedmean", num_byzantine=1), small, 1, small_ctx),
        mk("masked", get("trimmedmean", num_byzantine=1), tr, 1, ctx, part_mask=ones),
        mk("noctx", get("trimmedmean", num_byzantine=1), tr, 1, {}),
        mk("cc1", get("centeredclipping", tau=1.0), tr, 1, ctx),
        mk("cc2", get("centeredclipping", tau=2.0), tr, 1, ctx),
        mk("cc1b", get("centeredclipping", tau=1.0), tr, 3, ctx),
        mk("clu", get("clustering"), tr, 1, ctx),
        mk("clu_d", get("clustering", metric="distance"), tr, 1, ctx),
    ]


def test_plan_groups_matches_jax(sweep_inputs):
    jtr, jsmall = sweep_inputs
    jcells = _cells(JaxSweepCell, jax_get_aggregator, jtr, jsmall,
                    jaudit.battery_ctx(None, 6, 8, key=jax.random.PRNGKey(3)),
                    jaudit.battery_ctx(None, 4, 8), jnp.ones(6, bool))
    pcells = _cells(SweepCell, get_aggregator, torch.from_numpy(np.asarray(jtr)),
                    torch.from_numpy(np.asarray(jsmall)), contracts.battery_ctx(None, 6, 8),
                    contracts.battery_ctx(None, 4, 8), torch.ones(6, dtype=torch.bool))
    got = [[pcells[i].label for i in idx] for _, idx in plan_groups(pcells)]
    want = [[jcells[i].label for i in idx] for _, idx in jax_plan_groups(jcells)]
    assert got == want
    assert got[0] == ["tm1/f1", "tm1/f2"] and ["cc1", "cc1b"] in got
    assert group_key(pcells[0]) == group_key(pcells[1]) != group_key(pcells[2])


def test_certify_plan_groups_match_jax(monkeypatch):
    """The certify script's cells group as ``scripts/certify.py``'s do, with the same
    labels in the same order."""
    DrawBook(monkeypatch, 0, 1, 6, 8)
    args = _args(clients=6, dim=8, trials=1)
    _, jspecs = jax_certify.enumerate_cells(args)
    _, pspecs = certify.enumerate_cells(args, "cpu")
    assert [s.label for s in pspecs] == [s.label for s in jspecs]
    got = [[pspecs[i].label for i in idx] for _, idx in plan_groups(pspecs)]
    want = [[jspecs[i].label for i in idx] for _, idx in jax_plan_groups(jspecs)]
    assert got == want


# -- the certify script's main ------------------------------------------------


def _run_main(capsys, argv):
    rc = certify.main(argv)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_certify_main_one_json_line_and_matrix(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "ledger.jsonl"))
    out = tmp_path / "cert"
    rc, summary = _run_main(capsys, ["--device", "cpu", "--quick", "--clients", "6", "--dim",
                                     "8", "--trials", "1", "--aggs", "mean", "median",
                                     "--out", str(out)])
    assert rc == 0 and summary["ok"] is True, summary
    assert summary["cells"] == 2 * 3 and summary["async_cells"] == 2 * 3 * 2
    matrix = json.loads((out / "cert_matrix.json").read_text())
    assert matrix["headline_failures"] == [] and matrix["device"] == "cpu"
    sweeps = [json.loads(line) for line in (out / "sweep_trace.jsonl").read_text().splitlines()]
    from blades_tpu_torch.telemetry.schema import validate_records

    assert validate_records(sweeps) == []
    assert sum(r["t"] == "sweep" and "i" in r for r in sweeps) == certify.total_cells(
        _args(clients=6, aggs=["mean", "median"]))
    events = [json.loads(line)["event"]
              for line in (tmp_path / "ledger.jsonl").read_text().splitlines()]
    assert events == ["started", "finished"]


@pytest.mark.parametrize("argv,needle", [
    (["--aggs", "nosuchagg"], "unknown aggregators"),
    # with no server at ``sock``: the client's connection error, one line
    (["--via-service", "sock"], "unreachable"),
    (["--via-service", "sock", "--attempts", "3"], "unreachable"),
    (["--via-service", "sock", "--cell-deadline", "10"], "unreachable"),
])
def test_certify_main_refusals_are_one_json_line(tmp_path, capsys, monkeypatch, argv, needle):
    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "ledger.jsonl"))
    rc, summary = _run_main(capsys, ["--device", "cpu", "--quick", "--out",
                                     str(tmp_path / "c"), *argv])
    assert rc != 0 and summary["ok"] is False
    assert needle in summary["error"]


def test_certify_via_service_equals_the_in_process_matrix(tmp_path, capsys, monkeypatch):
    """``--via-service`` against a port server on the CPU: the served
    matrix's verdicts equal an in-process ``certify_matrix`` of the same
    spec exactly, its ratios within ``rtol=1e-4, atol=1e-6``."""
    import subprocess

    from blades_tpu_torch.service.client import ServiceClient

    ledger = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("BLADES_LEDGER", ledger)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BLADES_RESUME")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()))
    sock = tmp_path / "svc" / "service.sock"
    server = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                               "--out", str(tmp_path / "svc"), "--device", "cpu"], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    argv = ["--quick", "--clients", "6", "--aggs", "mean", "median", "--out",
            str(tmp_path / "c")]
    try:
        ServiceClient(str(sock), connect_retries=100, connect_delay_s=0.1).ping()
        rc, summary = _run_main(capsys, argv + ["--via-service", str(sock)])
        ServiceClient(str(sock)).drain()
        server.communicate(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    assert rc == 0 and summary["ok"] is True and summary["via_service"] is True
    served = json.loads((tmp_path / "c" / "cert_matrix.json").read_text())
    local = certify.certify_matrix(certify.parse_args(argv + ["--device", "cpu"]))
    assert served["device"] == local["device"] == "cpu"
    for key in ("cells", "async_cells"):
        assert [(r["agg"], r["f"], r["certified"]) for r in served[key]] == [
            (r["agg"], r["f"], r["certified"]) for r in local[key]]
        np.testing.assert_allclose([r["worst_ratio"] for r in served[key]],
                                   [r["worst_ratio"] for r in local[key]], rtol=1e-4, atol=1e-6)
    assert {n: {c: r["ok"] for c, r in b["contracts"].items()}
            for n, b in served["battery"].items()} == {
        n: {c: r["ok"] for c, r in b["contracts"].items()} for n, b in local["battery"].items()}
    assert served["headline_failures"] == local["headline_failures"] == []


def test_certify_main_asks_for_the_card_by_default(tmp_path, capsys, monkeypatch):
    """Without ``--device`` the script runs on the card, and without CUDA
    it says so (no quiet CPU fallback)."""
    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, summary = _run_main(capsys, ["--quick", "--aggs", "mean", "--out", str(tmp_path / "c")])
    assert rc != 0 and "cuda" in summary["error"].lower()
