"""The port's data layer against the JAX package's: the MNIST, CIFAR-10,
CIFAR-100 and custom loaders, the batched augmentation and the normalizer,
the sampler with a transform, ``get_train_data``, ``get_all_test_data``,
``from_client_arrays``, and one K=6 round each of the MLP on MNIST files
and of CCT-2 on CIFAR-10 files.

Every data file is written by the test itself, at a small size, into
``tmp_path``. Draws are injected: the JAX package's per-image augmentation
draws are reproduced from its key tree (``ku, kt = split(key)``, ``tkeys =
split(kt, N)``, then ``cifar_train_transform``'s own splits) and handed to
the port's ``apply_cifar_transform``.

Tolerances: stores, counts, shards, augmented images and normalized batches
bit for bit. The erasing box's height and width are truncated from a
float32 ``sqrt(frac * H * W * r)`` with ``r = exp(log_r)``; ``exp`` and
``sqrt`` may round an ulp apart between XLA and torch, which moves the
truncation only where the value lies within 1e-5 of an integer. Such
images are counted and excused (none in the seeded sets here). Rounds:
``rtol=atol=1e-5`` (the MLP's update matrix and params; CCT-2's leaf by
leaf, a tokenizer leaf by relative L2 below 2e-2 where a max-pool window
ties, ``ROADMAP.md`` queue C).
"""

import gzip
import os
import pickle
import struct
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.datasets import CIFAR10 as JaxCIFAR10
from blades_tpu.datasets import CIFAR100 as JaxCIFAR100
from blades_tpu.datasets import MNIST as JaxMNIST
from blades_tpu.datasets import CustomTensorDataset as JaxCustom
from blades_tpu.datasets import FLDataset as JaxFLDataset
from blades_tpu.datasets import augment as jaug
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import Trimmedmean
from blades_tpu_torch.attackers import Alie
from blades_tpu_torch.core import RoundEngine
from blades_tpu_torch.datasets import (
    CIFAR10,
    CIFAR100,
    MNIST,
    CustomTensorDataset,
    FLDataset,
    augment,
)
from blades_tpu_torch.models import build_fns, cct, create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng
from blades_tpu_torch.utils.logging import read_stats
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
#: the erasing box's pre-truncation float32 value this close to an integer
#: may truncate one apart between XLA and torch (module docstring)
BOX_EDGE = 1e-5


# -- data files, written by the tests -------------------------------------------------


def _images(n, shape, seed):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, (n,) + shape).astype(np.uint8), r.randint(0, 10, n)


def _write_idx(d, n_train=300, n_test=60, gz=False, seed=0):
    os.makedirs(d, exist_ok=True)
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    for prefix, n, s in (("train", n_train, seed), ("t10k", n_test, seed + 1)):
        x, y = _images(n, (28, 28), s)
        with opener(os.path.join(d, f"{prefix}-images-idx3-ubyte{ext}"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with opener(os.path.join(d, f"{prefix}-labels-idx1-ubyte{ext}"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.astype(np.uint8).tobytes())


def _write_mnist(root, kind, **kw):
    if kind == "npz":
        tx, ty = _images(300, (28, 28), 0)
        vx, vy = _images(60, (28, 28), 1)
        os.makedirs(root, exist_ok=True)
        np.savez(os.path.join(root, "mnist.npz"), train_x=tx, train_y=ty, test_x=vx, test_y=vy)
    elif kind == "raw_subdir":
        _write_idx(os.path.join(root, "MNIST", "raw"), **kw)
    else:
        _write_idx(root, gz=kind == "gz", **kw)


def _cifar_batch(path, n, seed, label_key=b"labels", classes=10):
    r = np.random.RandomState(seed)
    data = {b"data": r.randint(0, 256, (n, 3072)).astype(np.uint8),
            label_key: r.randint(0, classes, n).tolist()}
    with open(path, "wb") as f:
        pickle.dump(data, f)


def _write_cifar10(root, n_batch=40, n_test=50):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for i in range(1, 6):
        _cifar_batch(os.path.join(d, f"data_batch_{i}"), n_batch, i)
    _cifar_batch(os.path.join(d, "test_batch"), n_test, 9)
    return d


def _write_cifar100(root, n=200, n_test=50):
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    _cifar_batch(os.path.join(d, "train"), n, 1, b"fine_labels", 100)
    _cifar_batch(os.path.join(d, "test"), n_test, 2, b"fine_labels", 100)
    return d


def _assert_stores_equal(ours: FLDataset, ref):
    assert ours.train_x.dtype == torch.uint8
    np.testing.assert_array_equal(ours.train_x.numpy(), np.asarray(ref.train_x))
    np.testing.assert_array_equal(ours.train_y.numpy(), np.asarray(ref.train_y))
    np.testing.assert_array_equal(ours.train_counts.numpy(), np.asarray(ref.train_counts))
    np.testing.assert_array_equal(ours.test_x_raw.numpy(), np.asarray(ref.test_x_raw))
    np.testing.assert_array_equal(ours.test_y.numpy(), np.asarray(ref.test_y))
    for a, b in zip(ours.client_test_slices(), ref.client_test_slices()):
        np.testing.assert_array_equal(a, b)


# -- loaders ---------------------------------------------------------------------


@pytest.mark.parametrize("iid", [True, False], ids=["iid", "dirichlet"])
@pytest.mark.parametrize("kind", ["raw", "gz", "npz", "raw_subdir"])
def test_mnist_loads_like_jax(tmp_path, kind, iid):
    _write_mnist(str(tmp_path), kind)
    kw = dict(data_root=str(tmp_path), num_clients=7, iid=iid, alpha=0.5, seed=3, cache=False)
    ours, ref = MNIST(**kw).get_dls("cpu"), JaxMNIST(**kw).get_dls()
    _assert_stores_equal(ours, ref)
    assert ours.sample_shape == (28, 28, 1) and ours.transform is None


def test_mnist_partition_cache_matches_jax(tmp_path):
    """The partition archive has the JAX package's name and content."""
    _write_mnist(str(tmp_path / "a"), "raw")
    _write_mnist(str(tmp_path / "b"), "raw")
    kw = dict(num_clients=5, iid=False, alpha=0.3, seed=1)
    ours = MNIST(data_root=str(tmp_path / "a"), **kw)
    ref = JaxMNIST(data_root=str(tmp_path / "b"), **kw)
    ours.get_dls("cpu"), ref.get_dls()
    assert os.path.basename(ours._cache_path()) == os.path.basename(ref._cache_path())
    again = MNIST(data_root=str(tmp_path / "a"), **kw).get_dls("cpu")  # from the archive
    _assert_stores_equal(again, ref._fl)


@pytest.mark.parametrize("iid", [True, False], ids=["iid", "dirichlet"])
def test_cifar10_pickles_load_like_jax(tmp_path, iid):
    _write_cifar10(str(tmp_path))
    kw = dict(data_root=str(tmp_path), num_clients=6, iid=iid, alpha=0.5, seed=2, cache=False)
    ours, ref = CIFAR10(**kw).get_dls("cpu"), JaxCIFAR10(**kw).get_dls()
    _assert_stores_equal(ours, ref)
    assert ours.train_x.shape[2:] == (32, 32, 3)
    assert ours.transform is augment.cifar_train_transform


def test_cifar10_extracts_the_archive(tmp_path):
    """Only ``cifar-10-python.tar.gz`` under ``data_root/cifar10``: the
    loader extracts it beside itself and loads what the directory gives."""
    src = _write_cifar10(str(tmp_path / "src"))
    sub = tmp_path / "root" / "cifar10"
    sub.mkdir(parents=True)
    with tarfile.open(sub / "cifar-10-python.tar.gz", "w:gz") as tf:
        tf.add(src, arcname="cifar-10-batches-py")
    kw = dict(num_clients=4, seed=1, cache=False)
    ours = CIFAR10(data_root=str(tmp_path / "root"), **kw).get_dls("cpu")
    assert (sub / "cifar-10-batches-py" / "test_batch").exists()
    ref = JaxCIFAR10(data_root=str(tmp_path / "src"), **kw).get_dls()
    _assert_stores_equal(ours, ref)


def test_cifar100_reads_fine_labels(tmp_path):
    _write_cifar100(str(tmp_path))
    kw = dict(data_root=str(tmp_path), num_clients=5, iid=False, alpha=1.0, seed=4, cache=False)
    ds = CIFAR100(**kw)
    ours, ref = ds.get_dls("cpu"), JaxCIFAR100(**kw).get_dls()
    _assert_stores_equal(ours, ref)
    assert ds.num_classes == 100 and int(ours.train_y.max()) > 10
    m = ours.normalize
    np.testing.assert_array_equal(m.mean.numpy(), np.float32([0.5071, 0.4865, 0.4409]) * 255)


@pytest.mark.parametrize("cls,jcls", [(MNIST, JaxMNIST), (CIFAR10, JaxCIFAR10),
                                      (CIFAR100, JaxCIFAR100)], ids=["mnist", "cifar10",
                                                                      "cifar100"])
def test_missing_data_raises_without_downloading(tmp_path, cls, jcls):
    with pytest.raises(FileNotFoundError) as ours:
        cls(data_root=str(tmp_path), cache=False).get_dls("cpu")
    with pytest.raises(FileNotFoundError) as ref:
        jcls(data_root=str(tmp_path), cache=False).get_dls()
    assert "performs no network downloads" in str(ours.value)
    assert str(ours.value) == str(ref.value).replace("blades_tpu.", "blades_tpu_torch.")
    assert os.listdir(tmp_path) == []


def test_idx_magic_is_checked(tmp_path):
    _write_idx(str(tmp_path))
    path = tmp_path / "t10k-labels-idx1-ubyte"
    raw = path.read_bytes()
    path.write_bytes(struct.pack(">II", 2051, 60) + raw[8:])
    with pytest.raises(ValueError, match="bad magic 2051"):
        MNIST(data_root=str(tmp_path), cache=False).get_dls("cpu")


def test_custom_tensor_dataset_matches_jax():
    x, y = _images(120, (8, 8, 3), 5)
    tx, ty = _images(30, (8, 8, 3), 6)
    kw = dict(num_clients=4, iid=False, alpha=0.4, seed=2)
    norm = augment.make_normalizer((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))
    ds = CustomTensorDataset(x, y, tx, ty, transform=augment.cifar_train_transform,
                             normalize=norm, **kw)
    ours, ref = ds.get_dls("cpu"), JaxCustom(x, y, tx, ty, **kw).get_dls()
    _assert_stores_equal(ours, ref)
    assert ours.transform is augment.cifar_train_transform and ours.normalize is norm
    assert ds.num_classes == int(y.max()) + 1 and not ds.cache
    # without test arrays the train arrays are the test set
    alone = CustomTensorDataset(x, y, num_clients=3).get_dls("cpu")
    assert alone.test_x_raw.shape[0] == 120


# -- augmentation and the normalizer ----------------------------------------------


def jax_cifar_draws(tkeys, h, w, padding=4):
    """The per-image draws of ``jax.vmap(cifar_train_transform)(tkeys, x)``,
    reproduced from its key tree, as the port's ``CifarParams``."""

    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        ky, kx = jax.random.split(k1)
        e1, e2, e3, e4, e5 = jax.random.split(k3, 5)
        return (jax.random.randint(ky, (), 0, 2 * padding + 1),
                jax.random.randint(kx, (), 0, 2 * padding + 1),
                jax.random.bernoulli(k2, 0.5),
                jax.random.uniform(e1, (), minval=0.02, maxval=0.2),
                jax.random.uniform(e2, (), minval=jnp.log(0.3), maxval=jnp.log(3.3)),
                jax.random.randint(e3, (), 0, h),
                jax.random.randint(e4, (), 0, w),
                jax.random.bernoulli(e5, 0.25))

    draws = [np.array(a) for a in jax.vmap(one)(tkeys)]
    return augment.CifarParams(*[
        torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a) for a in draws])


def box_edge_images(params, h, w):
    """Images whose erasing box height or width lies within BOX_EDGE of an
    integer before truncation (float64 arithmetic on the f32 draws)."""
    frac = params.frac.double().numpy()
    r = np.exp(params.log_r.double().numpy())
    near = np.zeros(len(frac), bool)
    for v in (np.sqrt(frac * h * w * r), np.sqrt(frac * h * w / r)):
        near |= np.abs(v - np.round(v)) < BOX_EDGE
    return near & params.erase.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cifar_transform_on_jax_draws_matches_jax(dtype):
    n = 600
    r = np.random.RandomState(7)
    x = (r.randint(0, 256, (n, 32, 32, 3)) if dtype == np.uint8
         else r.randn(n, 32, 32, 3)).astype(dtype)
    tkeys = jax.random.split(jax.random.PRNGKey(11), n)
    ref = np.asarray(jax.jit(jax.vmap(jaug.cifar_train_transform))(tkeys, jnp.asarray(x)))
    params = jax_cifar_draws(tkeys, 32, 32)
    got = augment.apply_cifar_transform(torch.from_numpy(x), params).numpy()
    assert got.dtype == dtype
    excused = box_edge_images(params, 32, 32)
    assert excused.sum() == 0  # the seeded set has no box at an integer edge
    np.testing.assert_array_equal(got[~excused], ref[~excused])
    # every part of the transform ran on some image
    assert params.flip.any() and params.erase.any() and (params.top != 4).any()


def test_random_crop_and_hflip_match_numpy():
    x = np.random.RandomState(3).randint(0, 256, (50, 10, 12, 2)).astype(np.uint8)
    g = torch.Generator().manual_seed(5)
    cropped = augment.random_crop(torch.from_numpy(x), g, padding=3).numpy()
    g = torch.Generator().manual_seed(5)
    top, left = (torch.randint(0, 7, (50,), generator=g).numpy() for _ in range(2))
    pad = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    want = np.stack([pad[i, t:t + 10, l_:l_ + 12] for i, (t, l_) in enumerate(zip(top, left))])
    np.testing.assert_array_equal(cropped, want)

    flipped = augment.random_hflip(torch.from_numpy(x), torch.Generator().manual_seed(6)).numpy()
    flip = torch.rand(50, generator=torch.Generator().manual_seed(6)).numpy() < 0.5
    np.testing.assert_array_equal(flipped, np.where(flip[:, None, None, None],
                                                    x[:, :, ::-1], x))
    assert 0 < flip.sum() < 50


def test_random_erasing_matches_jax_per_image():
    """The batched erasing on draws made by the single-image JAX function's
    key tree equals that function image by image."""
    n = 200
    x = np.random.RandomState(4).randint(1, 256, (n, 16, 20, 3)).astype(np.uint8)
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    ref = np.asarray(jax.vmap(jaug.random_erasing)(keys, jnp.asarray(x)))

    def draws(key):
        e1, e2, e3, e4, e5 = jax.random.split(key, 5)
        return (jax.random.uniform(e1, (), minval=0.02, maxval=0.2),
                jax.random.uniform(e2, (), minval=jnp.log(0.3), maxval=jnp.log(3.3)),
                jax.random.randint(e3, (), 0, 16), jax.random.randint(e4, (), 0, 20),
                jax.random.bernoulli(e5, 0.25))

    frac, log_r, etop, eleft, erase = (torch.from_numpy(np.array(a))
                                       for a in jax.vmap(draws)(keys))
    got = augment.erase_boxes(torch.from_numpy(x), frac, log_r, etop.long(), eleft.long(),
                              erase).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any() and erase.any()
    # the seeded draw of the batched function zeroes boxes too, nothing else
    out = augment.random_erasing(torch.from_numpy(x), torch.Generator().manual_seed(1)).numpy()
    assert np.all((out == x) | (out == 0)) and (out == 0).any()


def test_draws_keep_the_jax_bounds_and_rates():
    p = augment.draw_cifar_params(torch.Generator().manual_seed(0), 20_000, 32, 32)
    assert int(p.top.min()) == 0 and int(p.top.max()) == 8 and int(p.left.max()) == 8
    assert int(p.etop.max()) == 31 and int(p.eleft.min()) == 0
    assert 0.02 <= float(p.frac.min()) and float(p.frac.max()) <= 0.2
    assert np.log(0.3) - 1e-6 <= float(p.log_r.min()) and float(p.log_r.max()) <= np.log(3.3)
    assert abs(float(p.flip.float().mean()) - 0.5) < 0.02
    assert abs(float(p.erase.float().mean()) - 0.25) < 0.02
    assert p.frac.dtype == p.log_r.dtype == torch.float32


@pytest.mark.parametrize("mean,std", [((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
                                      ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
                                      ((0.1307,), (0.3081,))], ids=["cifar10", "cifar100",
                                                                    "mnist"])
def test_normalizer_matches_jitted_and_eager_jax(mean, std):
    """The sampler's form (times the reciprocal) equals the jitted JAX
    normalizer and the divide form the eager one, bit for bit; the two
    forms differ somewhere on the 256 byte values."""
    c = len(mean)
    x = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None, None],
                        (256, 2, 2, c)).copy()
    jn, tn = jaug.make_normalizer(mean, std), augment.make_normalizer(mean, std)
    jitted, eager = np.asarray(jax.jit(jn)(jnp.asarray(x))), np.asarray(jn(jnp.asarray(x)))
    np.testing.assert_array_equal(tn(torch.from_numpy(x)).numpy(), jitted)
    np.testing.assert_array_equal(tn.divide(torch.from_numpy(x)).numpy(), eager)
    assert not np.array_equal(jitted, eager)


# -- the sampler, the streams and the test shards ------------------------------------


CIFAR_STATS = ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616))


def _store(k=5, n=60, seed=0):
    """A CIFAR-shaped uint8 store, Dirichlet-partitioned (ragged counts)."""
    x, y = _images(n * k, (32, 32, 3), seed)
    tx, ty = _images(40, (32, 32, 3), seed + 1)
    kw = dict(num_clients=k, iid=False, alpha=0.5, seed=seed)
    ours = CustomTensorDataset(x, y, tx, ty, normalize=augment.make_normalizer(*CIFAR_STATS),
                               **kw).get_dls("cpu")
    ref = JaxCustom(x, y, tx, ty, transform=jaug.cifar_train_transform,
                    normalize=jaug.make_normalizer(*CIFAR_STATS), **kw).get_dls()
    return ours, ref


@pytest.mark.parametrize("steps,batch", [(1, 4), (2, 3)])
def test_sampler_with_transform_matches_jax_sampler(monkeypatch, steps, batch):
    """JAX's order draws ``u`` and per-image draws, handed to the port's
    sampler (its ``torch.rand`` for ``u``; a transform applying the JAX
    draws), equal the JAX package's jitted sampler bit for bit."""
    ours, ref = _store()
    key = jax.random.PRNGKey(5)
    k, n_max = ours.train_y.shape
    ku, kt = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(ku, (k, n_max))))
    params = jax_cifar_draws(jax.random.split(kt, k * steps * batch), 32, 32)
    real_rand = torch.rand

    def rand(*shape, **kw):
        return u.clone() if tuple(shape[0]) == (k, n_max) else real_rand(*shape, **kw)

    monkeypatch.setattr(torch, "rand", rand)
    ours.transform = lambda x, g: augment.apply_cifar_transform(x, params)
    ours._samplers = {}
    cx, cy = ours.sample_round(torch.Generator(), steps, batch)
    jcx, jcy = jax.jit(ref._make_sample_fn(steps, batch))(key)
    assert cx.dtype == torch.float32 and cx.shape == (k, steps, batch, 32, 32, 3)
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))


def test_sampler_draws_the_transform_after_the_order():
    """The transform draws from the sampler's generator after the order:
    the same generator picks the same samples with and without it, and the
    generator ends where the order and the draws leave it."""
    ours, _ = _store()
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    _, cy = ours.sample_round(g(), 2, 4)
    plain = FLDataset(ours.train_x.numpy(), ours.train_y.numpy(), ours.train_counts.numpy(),
                      ours.test_x_raw.numpy(), ours.test_y.numpy())
    px, py = plain.sample_round(g(), 2, 4)
    np.testing.assert_array_equal(cy.numpy(), py.numpy())
    assert px.dtype == torch.uint8  # no normalizer: the raw store's batch

    ours.transform, ours._samplers = augment.cifar_train_transform, {}
    gen = g()
    tx, ty = ours.sample_round(gen, 2, 4)
    np.testing.assert_array_equal(ty.numpy(), py.numpy())
    k, n_max = ours.train_y.shape
    after = g()
    torch.rand((k, n_max), generator=after)
    want = augment.apply_cifar_transform(px.reshape(-1, 32, 32, 3),
                                         augment.draw_cifar_params(after, k * 8, 32, 32))
    np.testing.assert_array_equal(tx.numpy(), ours.normalize(want).reshape(tx.shape).numpy())
    assert not torch.equal(tx, ours.normalize(px))  # the transform moved pixels
    assert torch.equal(gen.get_state(), after.get_state())


def test_test_x_divides_like_the_eager_jax_property(tmp_path):
    _write_cifar10(str(tmp_path))
    kw = dict(data_root=str(tmp_path), num_clients=4, seed=0, cache=False)
    ours, ref = CIFAR10(**kw).get_dls("cpu"), JaxCIFAR10(**kw).get_dls()
    np.testing.assert_array_equal(ours.test_x.numpy(), np.asarray(ref.test_x))
    assert ours.test_x.dtype == torch.float32 and ours.test_x_raw.dtype == torch.uint8
    for u in (None, 0, 3):
        (x, y), (jx, jy) = ours.get_all_test_data(u), ref.get_all_test_data(u)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("normalized", [False, True])
def test_get_train_data_epochs_match_jax(tmp_path, normalized):
    """Each client's without-replacement epochs, the partial last batch and
    the reshuffle on wraparound, across calls, as the JAX package's."""
    _write_mnist(str(tmp_path), "raw")
    kw = dict(data_root=str(tmp_path), num_clients=6, iid=False, alpha=0.5, seed=1,
              cache=False)
    ours, ref = MNIST(**kw).get_dls("cpu"), JaxMNIST(**kw).get_dls()
    if not normalized:
        ours.normalize = ref.normalize = None
    for u, calls in ((0, (3, 4)), (4, (1, 7, 2)), (0, (5,))):
        for num in calls:
            got, want = ours.get_train_data(u, num, batch_size=16), ref.get_train_data(u, num, 16)
            assert len(got) == len(want) == num
            for (x, y), (jx, jy) in zip(got, want):
                np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
                np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    # a generator seeds a stream on its first use; the same seed, the same stream
    a = ours.get_train_data(2, 3, 8, generator=torch.Generator().manual_seed(4))
    ours._streams.clear()
    b = ours.get_train_data(2, 3, 8, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(p[1], q[1]) for p, q in zip(a, b))


@pytest.mark.parametrize("per_client_test", [False, True], ids=["union", "lists"])
def test_from_client_arrays_matches_jax(per_client_test):
    r = np.random.RandomState(0)
    xs = [r.randint(0, 256, (n, 6, 6, 1)).astype(np.uint8) for n in (5, 9, 2)]
    ys = [r.randint(0, 10, len(a)) for a in xs]
    tests = [r.randint(0, 256, (n, 6, 6, 1)).astype(np.uint8) for n in (3, 1, 4)]
    tys = [r.randint(0, 10, len(a)) for a in tests]
    if per_client_test:
        tx, ty = tests, tys
    else:
        tx, ty = np.concatenate(tests), np.concatenate(tys)
    ours = FLDataset.from_client_arrays(xs, ys, tx, ty, client_ids=["a", "b", "c"])
    ref = JaxFLDataset.from_client_arrays(xs, ys, tx, ty, client_ids=["a", "b", "c"])
    _assert_stores_equal(ours, ref)
    np.testing.assert_array_equal(ours.test_counts, ref.test_counts)
    x, _ = ours.get_all_test_data("b")
    jx, _ = ref.get_all_test_data("b")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert ours.get_clients() == ["a", "b", "c"]


# -- rounds on data from files ------------------------------------------------------------


K6, F2 = 6, 2


def _round_pair(jspec, tspec, jparams, cx, cy, layout):
    jeng = JaxRoundEngine(jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=K6,
                          num_byzantine=F2, attack=JaxAlie(num_clients=K6, num_byzantine=F2),
                          aggregator=JaxTrimmedmean(num_byzantine=F2), plan=None,
                          keep_updates=True)
    tparams = params_from_jax(jparams, layout)
    teng = RoundEngine(tspec.train_loss_fn, tspec.eval_logits_fn, tparams, layout,
                       num_clients=K6, num_byzantine=F2,
                       attack=Alie(num_clients=K6, num_byzantine=F2),
                       aggregator=Trimmedmean(num_byzantine=F2), keep_updates=True,
                       device="cpu", noise_sites=tspec.noise_sites)
    jstate, _ = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy), 0.1, 1.0,
                               jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx), torch.from_numpy(cy),
                                0.1, 1.0)
    assert np.isfinite(float(tm.train_loss))
    return (np.asarray(jeng.last_updates), np.asarray(ravel_pytree(jstate.params)[0]),
            teng.last_updates.numpy(), ravel(tstate.params, layout).numpy())


def test_mlp_round_on_mnist_files_matches_jax(tmp_path):
    _write_mnist(str(tmp_path), "gz", n_train=240)
    kw = dict(data_root=str(tmp_path), num_clients=K6, iid=False, alpha=0.5, seed=0,
              cache=False)
    ours, ref = MNIST(**kw).get_dls("cpu"), JaxMNIST(**kw).get_dls()
    cx, cy = (np.array(a) for a in jax.jit(ref._make_sample_fn(2, 8))(jax.random.PRNGKey(1)))
    assert cx.dtype == np.float32 and np.isclose(cx.mean(), 0.3, atol=2.0)
    jspec, tspec = jax_mlp(), create_mnist_model()
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    ju, jp, tu, tp = _round_pair(jspec, tspec, jparams, cx, cy, tspec.layout)
    np.testing.assert_allclose(tu, ju, **TOL)
    np.testing.assert_allclose(tp, jp, **TOL)


def test_cct2_round_on_cifar_files_matches_jax(tmp_path, monkeypatch):
    """The JAX sampler's augmented, normalized batch of CIFAR-10 files
    (which the port's sampler reproduces from the same draws) trains one
    K=6 CCT-2 round (no dropout) in both packages; the update matrix and
    the params agree leaf by leaf."""
    _write_cifar10(str(tmp_path))
    kw = dict(data_root=str(tmp_path), num_clients=K6, iid=False, alpha=0.5, seed=0,
              cache=False)
    ours, ref = CIFAR10(**kw).get_dls("cpu"), JaxCIFAR10(**kw).get_dls()
    key = jax.random.PRNGKey(3)
    cx, cy = (np.array(a) for a in jax.jit(ref._make_sample_fn(1, 4))(key))
    ku, kt = jax.random.split(key)
    k, n_max = ours.train_y.shape
    u = torch.from_numpy(np.array(jax.random.uniform(ku, (k, n_max))))
    params = jax_cifar_draws(jax.random.split(kt, k * 4), 32, 32)
    real_rand = torch.rand
    monkeypatch.setattr(torch, "rand", lambda *s, **kw: u.clone() if tuple(s[0]) == (k, n_max)
                        else real_rand(*s, **kw))
    ours.transform = lambda x, g: augment.apply_cifar_transform(x, params)
    tcx, tcy = ours.sample_round(torch.Generator(), 1, 4)
    monkeypatch.undo()
    np.testing.assert_array_equal(tcx.numpy(), cx)
    np.testing.assert_array_equal(tcy.numpy(), cy)

    no_noise = dict(attention_dropout=0.0, stochastic_depth=0.0)
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**no_noise), (32, 32, 3))
    tspec = build_fns(cct.cct_2_3x2_32(**no_noise))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    ju, jp, tu, tp = _round_pair(jspec, tspec, jparams, cx, cy, tspec.layout)
    assert tu.shape == (K6, 283_723)
    off = 0
    for leaf in tspec.layout.leaves:
        sl = slice(off, off + leaf.size)
        off += leaf.size
        for got, want in ((tu[:, sl], ju[:, sl]), (tp[sl], jp[sl])):
            if leaf.jax_path[0] == "Tokenizer_0" and not np.allclose(got, want, **TOL):
                rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
                assert rel < 2e-2, "/".join(leaf.jax_path)
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg="/".join(leaf.jax_path))


# -- the Simulator on files, and the mini example -----------------------------------------


def test_simulator_runs_cifar10_files_on_uint8_store(tmp_path):
    """``Simulator(CIFAR10(...))``: the store stays uint8, CCT-2 is sized
    from it, the sampler augments and normalizes inside eager blocks, and
    evaluation reads the normalized test set."""
    _write_cifar10(str(tmp_path / "data"))
    ds = CIFAR10(data_root=str(tmp_path / "data"), num_clients=4, iid=False, alpha=0.5,
                 cache=False)
    sim = Simulator(ds, attack="alie", num_byzantine=1, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": 1}, device="cpu",
                    log_path=str(tmp_path / "out"))
    sim.run("cct_2_3x2_32", global_rounds=2, train_batch_size=2, block_size=2,
            compute_dtype="bfloat16", test_batch_size=32)
    assert sim.dataset.train_x.dtype == torch.uint8
    assert sim.engine.last_block_mode == "eager"
    test = read_stats(str(tmp_path / "out"), "test")
    assert len(test) == 1 and np.isfinite(test[0]["Loss"])
    assert len(read_stats(str(tmp_path / "out"), "train")) == 2


def test_mini_example_runs_on_mnist_files(tmp_path, monkeypatch):
    from blades_tpu_torch.examples import mini_example

    _write_mnist(str(tmp_path / "data"), "gz", n_train=200)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MINI_ROUNDS", "2")
    monkeypatch.setenv("MINI_STEPS", "2")
    sim = mini_example.main(["--device", "cpu"])
    assert isinstance(sim.dataset, FLDataset) and sim.dataset.normalize is not None
    assert sim.server.state.round_idx == 2 and sim.num_byzantine == 4
    assert len(read_stats(str(tmp_path / "outputs"), "train")) == 2
    g = rng.generator(1, 1, rng.DATA)
    cx, _ = sim.dataset.sample_round(g, 2, 32)
    assert cx.dtype == torch.float32 and cx.shape == (10, 2, 32, 28, 28, 1)
