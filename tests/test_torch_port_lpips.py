"""The port's utils/lpips.py against the JAX package's, on the CPU.

Random weights carried across by convert.lpips_to_jax_params (the
calibrated weights are not in the repository). Bands: the five feature
maps and the distances at 1e-5 relative (f32 convolutions summed in
another order); the converters exactly (a transpose).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, np_, t, uniform
from hunyuanworld_mirror_tpu.training import checkpoint as jckpt
from hunyuanworld_mirror_tpu.utils import lpips as jl
from hunyuanworld_mirror_tpu_torch import convert
from hunyuanworld_mirror_tpu_torch.utils import lpips as pl


def _net(seed):
    return pl.init_random(torch.Generator().manual_seed(seed))


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) == 15
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("hw", [(64, 64), (70, 58)])
def test_features_match_jax(hw):
    """The five ReLU maps (odd sizes take the VALID pools' floor)."""
    net = _net(0)
    params = convert.lpips_to_jax_params(net)
    x = uniform(1, (2, *hw, 3))
    fj = jl._features(params, jnp.asarray(x))
    fp = net.features(t(x))
    assert [f.shape[1] for f in fp] == [64, 192, 384, 256, 256]
    for a, b in zip(fp, fj):
        b = np.asarray(b)
        close(np_(a).transpose(0, 2, 3, 1), b, atol=1e-5 * np.abs(b).max())


def test_distance_matches_jax_and_is_a_distance():
    net = _net(1)
    params = convert.lpips_to_jax_params(net)
    a, b = uniform(2, (3, 48, 56, 3)), uniform(3, (3, 48, 56, 3))
    dj = np.asarray(jl.distance(params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        dp = pl.distance(net, t(a), t(b))
        assert dp.shape == (3,)
        close(dp, dj, 0.0, rtol=1e-5)
        close(pl.distance(net, t(b), t(a)), dp, 0.0, rtol=1e-6)
        close(pl.distance(net, t(a), t(a)), np.zeros(3), 1e-6)
    assert np.all(np_(dp) > 0)


def test_init_random_structure():
    """The production structure, JAX init_random's draws: the heads in
    [0, 0.1), the convs within kaiming-uniform's sqrt(1 / fan_in); a seed
    gives the same net."""
    net = _net(2)
    jparams = jax.jit(jl.init_random)(jax.random.PRNGKey(0))
    for leaf_p, leaf_j in zip(jax.tree.leaves(convert.lpips_to_jax_params(net)),
                              jax.tree.leaves(jparams)):
        assert leaf_p.shape == np.asarray(leaf_j).shape
    for conv in net.convs:
        assert float(conv.weight.detach().abs().max()) <= conv.weight[0].numel() ** -0.5
    for lin in net.lins:
        w = lin.weight.detach()
        assert 0.0 <= float(w.min()) and float(w.max()) < 0.1
    _leaves_equal(convert.lpips_to_jax_params(net), convert.lpips_to_jax_params(_net(2)))


def _package_state_dict(rng, scheme):
    """A synthetic `lpips` package state dict in either naming scheme."""
    feat_idx, cins = [0, 3, 6, 8, 10], [3, 64, 192, 384, 256]
    slices = [1, 2, 3, 4, 5]
    sd = {}
    for i, (cout, k, _, _) in enumerate(jl._ALEX):
        pre = (f"features.{feat_idx[i]}" if scheme == "features"
               else f"net.slice{slices[i]}.{feat_idx[i]}")
        sd[f"{pre}.weight"] = rng.normal(size=(cout, cins[i], k, k)).astype(np.float32) * 0.05
        sd[f"{pre}.bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.05
    for i, c in enumerate(jl._CHANNELS):
        sd[f"lin{i}.model.1.weight"] = rng.uniform(size=(1, c, 1, 1)).astype(np.float32) * 0.1
    return sd


@pytest.mark.parametrize("scheme", ["features", "slices"])
def test_convert_torch_state_matches_jax(scheme):
    sd = _package_state_dict(np.random.default_rng(4), scheme)
    pp, pj = pl.convert_torch_state(sd), jl.convert_torch_state(sd)
    _leaves_equal(pp, pj)
    # the package's own tensors load into the module through the pytree
    net = pl.as_module(pp)
    np.testing.assert_array_equal(np_(net.lins[2].weight), sd["lin2.model.1.weight"])
    key = "features.3.weight" if scheme == "features" else "net.slice2.3.weight"
    np.testing.assert_array_equal(np_(net.convs[1].weight), sd[key])
    with pytest.raises(KeyError):
        pl.convert_torch_state({k: v for k, v in sd.items() if ".6." not in k})


def test_jax_param_map_round_trip():
    net = _net(5)
    tree = convert.lpips_to_jax_params(net)
    sd = convert.lpips_from_jax_params(tree)
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(np_(sd[k]), np_(v))
    assert pl.as_module(net) is net


def test_load_params_reads_a_jax_saved_npz(tmp_path, monkeypatch):
    """An npz the JAX package's save_params wrote (its lists as digit keys):
    by path and through $WM_LPIPS_WEIGHTS, the JAX tree, whose net gives
    JAX's distances."""
    params = convert.lpips_to_jax_params(_net(6))
    path = str(tmp_path / "lpips.npz")
    jckpt.save_params(path, params)
    loaded = pl.load_params(path)
    _leaves_equal(loaded, jl.load_params(path))
    monkeypatch.setenv("WM_LPIPS_WEIGHTS", path)
    _leaves_equal(pl.load_params(), params)
    a, b = uniform(7, (2, 40, 40, 3)), uniform(8, (2, 40, 40, 3))
    with torch.no_grad():
        dp = pl.distance(pl.as_module(loaded), t(a), t(b))
    close(dp, jl.distance(params, jnp.asarray(a), jnp.asarray(b)), 0.0, rtol=1e-5)


def test_gate_closed_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("WM_LPIPS_WEIGHTS", raising=False)
    assert pl.load_params() is None and jl.load_params() is None
    monkeypatch.setenv("WM_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert pl.load_params() is None and jl.load_params() is None
    assert pl.load_params(str(tmp_path / "absent.npz")) is None


@pytest.mark.parametrize("hw", [(24, 20), (5, 5), (30, 40), (31, 31)])
def test_small_images_as_jax(hw):
    """Under 31 px a VALID pool leaves JAX an empty map and a NaN distance;
    the port gives the same rather than raising."""
    net = _net(9)
    a, b = uniform(10, (2, *hw, 3)), uniform(11, (2, *hw, 3))
    dj = np.asarray(jl.distance(convert.lpips_to_jax_params(net), jnp.asarray(a),
                                jnp.asarray(b)))
    with torch.no_grad():
        dp = np_(pl.distance(net, t(a), t(b)))
    assert np.isnan(dp).tolist() == np.isnan(dj).tolist() == [min(hw) < 31] * 2
    close(dp, dj, 0.0, rtol=1e-5)
