"""Port vs JAX: prior prompting. The rotation and camera encoders, the pose
and depth normalisation (every branch), the sort-based quantiles (past
torch.nanquantile's input limit too), the priors' extraction and the
aggregator's prior tokens for every cond-flag combination, with the priors
present and absent.

Bands: the encoders, the normalisation and the quantiles within 1e-6 (f32,
the same operations on both sides); the aggregator at the trunk's f32 band,
2e-4 (tests/test_torch_port_encoder_trunk.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import close, normal, state_dict_np, t, uniform
from hunyuanworld_mirror_tpu.models import aggregator as jagg
from hunyuanworld_mirror_tpu.models import worldmirror as jwm
from hunyuanworld_mirror_tpu.utils import camera as jcam
from hunyuanworld_mirror_tpu.utils import priors as jpri
from hunyuanworld_mirror_tpu.utils import rotation as jrot
from hunyuanworld_mirror_tpu_torch.models import aggregator as pagg
from hunyuanworld_mirror_tpu_torch.models import nn as pnn
from hunyuanworld_mirror_tpu_torch.models import worldmirror as pwm
from hunyuanworld_mirror_tpu_torch.utils import camera as pcam
from hunyuanworld_mirror_tpu_torch.utils import priors as ppri
from hunyuanworld_mirror_tpu_torch.utils import rotation as prot
from tools import convert_weights as cw

BAND = 1e-6
TRUNK_BAND = 2e-4


def _rotations(seed, n):
    """n random rotation matrices (from normalised random quaternions)."""
    q = normal(seed, (n, 4))
    return np.asarray(jrot.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(
        q, axis=-1, keepdims=True))))


def _half_turns():
    """Rotations by ~180 degrees (and exactly 180) about x, y and z: their
    largest candidate denominators are i, j and k."""
    mats = []
    for axis in range(3):
        for angle in (math.pi - 1e-3, math.pi):
            c, s = math.cos(angle), math.sin(angle)
            a, b = [i for i in range(3) if i != axis]
            m = np.eye(3)
            m[a, a], m[a, b], m[b, a], m[b, b] = c, -s, s, c
            mats.append(m)
    return np.asarray(mats, np.float32)


def _pose_stack(seed, B, S):
    """(B, S, 4, 4) camera poses: random rotations, translations up to 3."""
    ext = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    ext[:, :, :3, :3] = _rotations(seed, B * S).reshape(B, S, 3, 3)
    ext[:, :, :3, 3] = normal(seed + 1, (B, S, 3), 3.0)
    return ext


@pytest.mark.parametrize("case", ["random", "half_turns"])
def test_rotmat_to_quat(case):
    R = _rotations(0, 64) if case == "random" else _half_turns()
    ours = prot.rotmat_to_quat(t(R))
    close(ours, jrot.rotmat_to_quat(jnp.asarray(R)), BAND)
    if case == "half_turns":
        # each axis' pair picks the candidate of i, j and k in turn
        m = t(R).reshape(-1, 9)
        q_abs = torch.stack([1 + m[:, 0] + m[:, 4] + m[:, 8], 1 + m[:, 0] - m[:, 4] - m[:, 8],
                             1 - m[:, 0] + m[:, 4] - m[:, 8], 1 - m[:, 0] - m[:, 4] + m[:, 8]], -1)
        assert torch.argmax(q_abs, -1).tolist() == [1, 1, 2, 2, 3, 3]
    assert bool((ours[:, 3] >= 0).all())


def test_camera_encoders():
    ext = _pose_stack(3, 2, 3)[:, :, :3]
    K = np.tile(np.array([[300, 0, 60], [0, 250, 50], [0, 0, 1]], np.float32), (2, 3, 1, 1))
    K[..., 0, 0] += uniform(4, (2, 3), 0, 50)
    close(pcam.camera_params_to_vector(t(ext), t(K), (100, 120)),
          jcam.camera_params_to_vector(jnp.asarray(ext), jnp.asarray(K), (100, 120)), BAND)
    vec = pcam.extrinsics_to_vector(t(ext))
    close(vec, jcam.extrinsics_to_vector(jnp.asarray(ext)), BAND)
    assert vec.dtype == torch.float32
    close(pcam.vector_to_extrinsics(vec),
          jcam.vector_to_extrinsics(jnp.asarray(vec.numpy())), BAND)
    close(pcam.vector_to_extrinsics(vec), ext, 1e-5)              # the round trip


@pytest.mark.parametrize("S", [4, 12], ids=["min_max", "percentiles"])
def test_normalize_poses(S):
    """S <= 10 bounds the centres by min/max, S > 10 by the 5/95
    percentiles; a NaN and an inf entry go through nan_to_num."""
    ext = _pose_stack(5, 2, S)[:, :, :3]
    ext[1, 2, 0, 3] = np.nan
    ext[1, 3, 1, 3] = np.inf
    ours = ppri.normalize_poses(t(ext))
    close(ours, jpri.normalize_poses(jnp.asarray(ext)), BAND)
    assert float(ours[..., 3].min()) >= 0 and float(ours[..., 3].max()) <= 1


def _depth_case(case):
    d = uniform(6, (1, 2, 24, 24), 0.5, 8.0)
    if case == "few_valid":          # exactly 100 valid pixels in frame 0
        d[0, 0].reshape(-1)[100:] = 0.0
    elif case == "all_zero":
        d[0, 1] = 0.0
    elif case == "constant":
        d[0, 0] = 2.5
    elif case == "non_finite":
        d[0, 0, 0, :3] = [np.nan, np.inf, -np.inf]
        d[0, 1, 5, 5] = np.inf
    return d


@pytest.mark.parametrize("case", ["many_valid", "few_valid", "all_zero",
                                  "constant", "non_finite"])
def test_normalize_depth(case):
    """Quantile bounds above 100 valid pixels, the non-zero min/max at or
    below, the min/max of all without any, a unit range for a constant map;
    NaN and +-inf through nan_to_num."""
    d = _depth_case(case)
    close(ppri.normalize_depth(t(d)), jpri.normalize_depth(jnp.asarray(d)), BAND)


def test_sorted_nanquantile_matches_torch():
    x = t(normal(7, (6, 333)))
    x[x < -0.8] = float("nan")
    x[4] = float("nan")                                   # a row with none valid
    x[5, 1:] = float("nan")                               # one valid value
    qs = (0.0, 0.01, 0.05, 0.5, 0.95, 0.99, 1.0)
    for q, ours in zip(qs, ppri.sorted_nanquantile(x, qs)):
        ref = torch.nanquantile(x, q, dim=-1, interpolation="linear")
        assert ours.isnan().tolist() == ref.isnan().tolist()
        close(ours.nan_to_num(), ref.nan_to_num(), 1e-6, err_msg=str(q))
    close(ppri.normalize_depth_fixed(t([[-1.0, 5.0, 30.0]])),
          jpri.normalize_depth_fixed(jnp.asarray([[-1.0, 5.0, 30.0]])), BAND)


def test_sorted_nanquantile_past_torch_limit():
    """A stack of 65 x 2^18 depths, past the 2^24 elements torch.nanquantile
    takes at once (B*S = 65 frames of 512 x 512): each row against
    torch.nanquantile of that row alone."""
    x = torch.rand(65, 1 << 18, generator=torch.Generator().manual_seed(11))
    x[x < 0.1] = float("nan")
    assert x.numel() > 1 << 24
    for q, ours in zip((0.01, 0.99), ppri.sorted_nanquantile(x, (0.01, 0.99))):
        ref = torch.stack([torch.nanquantile(row, q, interpolation="linear") for row in x])
        close(ours, ref, 1e-6, err_msg=str(q))


def _prior_views(B=1, S=3, H=56, W=56, seed=8):
    K = np.tile(np.array([[60, 0, W / 2], [0, 55, H / 2], [0, 0, 1]], np.float32),
                (B, S, 1, 1))
    return {"camera_pose": _pose_stack(seed, B, S),
            "camera_intrinsics": K,
            "depthmap": uniform(seed + 2, (B, S, H, W), 0.5, 6.0)}


def test_extract_priors():
    views = _prior_views()
    ours = pwm.extract_priors({k: t(v) for k, v in views.items()}, (56, 56))
    ref = jwm.extract_priors({k: jnp.asarray(v) for k, v in views.items()}, (56, 56))
    for o, r in zip(ours, ref):
        close(o, r, BAND)
    assert pwm.extract_priors({}, (56, 56)) == (None, None, None)


@pytest.fixture(scope="module")
def trunk():
    kw = dict(img_size=56, embed_dim=64, depth=2, num_heads=4, patch_embed="conv",
              enable_cond=True, intermediate_idxs=(0, 1, 1, 1))
    agg = pagg.VisualGeometryTransformer(pagg.VGTConfig(**kw))
    pnn.init_weights(agg, torch.Generator().manual_seed(9))
    imgs = uniform(10, (1, 3, 56, 56, 3))
    views = _prior_views()
    priors = pwm.extract_priors({k: t(v) for k, v in views.items()}, (56, 56))
    return agg, cw.convert_vgt(state_dict_np(agg)), jagg.VGTConfig(**kw), imgs, priors


@pytest.mark.parametrize("present", [True, False], ids=["priors", "no_priors"])
@pytest.mark.parametrize("flags", [(p, d, r) for p in (0, 1) for d in (0, 1)
                                   for r in (0, 1)],
                         ids=lambda f: "cond" + "".join(map(str, f)))
def test_aggregator_prior_tokens(trunk, flags, present):
    """Pose and ray tokens (zero where the flag is off or the prior absent)
    and the depth tokens added to the patch tokens, against the JAX
    aggregator; the patch start stays 7."""
    agg, params, cfg_j, imgs, priors = trunk
    priors = priors if present else (None, None, None)
    with torch.no_grad():
        outs, start = agg(t(imgs), priors, flags, dtype=torch.float32)
    refs, start_j = jagg.forward(
        params, cfg_j, jnp.asarray(imgs), dtype=jnp.float32, cond_flags=flags,
        priors=tuple(None if p is None else jnp.asarray(p.numpy()) for p in priors))
    assert start == start_j == 7
    for o, r in zip(outs, refs):
        close(o, r, TRUNK_BAND)
