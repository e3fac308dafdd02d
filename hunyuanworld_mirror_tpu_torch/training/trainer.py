"""Training loop for the CenterSnap 6D-pose workload.

Port of hunyuanworld_mirror_tpu/training/trainer.py: AdamW (5e-5, weight
decay 0.05) under a cosine schedule, WDS-shard streaming, a test pass
every epoch, a checkpoint every `ckpt_every_epochs`, resume (params,
optimizer and step), TensorBoard scalars and images. `arch="transformer"`
trains models/centersnap.CenterSnap (its bf16 trunk runs K1 forward and
the einsum replay backward on the card), `arch="res_fpn"` the ResNet-FPN
baseline models/panoptic.Panoptic.

The optimizer is optax.adamw(optax.cosine_decay_schedule(lr, epochs *
steps_per_epoch), weight_decay) as the JAX trainer builds it: every
trainable parameter decays (biases and norms too), a parameter the loss
does not reach still steps on a zero gradient, and update t takes the rate
lr * (1 + cos(pi * min(t, T) / T)) / 2. A frozen parameter (requires_grad
False: CenterSnap's DINO backbone) is neither stepped nor decayed, and its
moments are saved as zeros.

One iteration of the loop (`train_iteration`) is one request of
utils/profiling: the batch's uploads (each a host sync, counted in
`host_syncs`), then the step's spans forward (with `loss` inside it),
backward and optimizer.
"""

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import convert, resolve_device
from ..models.centersnap import CenterSnap, CenterSnapConfig
from ..models.nn import init_weights
from ..models.panoptic import Panoptic
from ..utils.priors import normalize_depth_fixed
from ..utils import profiling
from . import checkpoint as ckpt_lib
from . import losses

# ImageNet statistics: the panoptic baseline takes normalized RGB
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass
class TrainConfig:
    train_shards: str = ""
    test_shards: str = ""
    batch_size: int = 20
    epochs: int = 10
    lr: float = 5e-5
    weight_decay: float = 0.05
    steps_per_epoch: int = 18000   # the cosine horizon is epochs * this
    log_every: int = 100
    # image grids and bbox overlays every vis_every steps; 0 disables
    vis_every: int = 14000
    ckpt_every_epochs: int = 2
    ckpt_path: str = "checkpoints/centersnap.npz"
    resume: Optional[str] = None
    seed: int = 0
    # "transformer" = CenterSnap, "res_fpn" = the ResNet-FPN baseline
    arch: str = "transformer"
    model: Any = field(default_factory=CenterSnapConfig)


def model_init(cfg: TrainConfig, device=None) -> torch.nn.Module:
    """The model of `cfg.arch`, its parameters drawn from `cfg.seed` (the
    JAX package's distributions, not its values)."""
    model = Panoptic(cfg.model) if cfg.arch == "res_fpn" else CenterSnap(cfg.model)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device)


def model_forward(cfg: TrainConfig, model: torch.nn.Module, batch: Dict):
    if cfg.arch == "res_fpn":
        return model(batch["rgb"], batch["depth"])
    return model(batch["rgb"], batch.get("depth"))


def cosine_decay(init_value: float, decay_steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(init_value, decay_steps) at `count`."""
    t = min(count, decay_steps)
    return init_value * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


class AdamWCosine:
    """optax.adamw(cosine_decay_schedule(lr, decay_steps), weight_decay)
    over the parameters the JAX pytree holds (convert.jax_leaves) that
    require grad, on torch's AdamW (decoupled decay, eps outside the square
    root) with the rate set before each update. decay_steps=None keeps the
    rate constant (optax.adamw(lr, weight_decay=...)). `params` lists every
    leaf, frozen ones too, in `leaves`' order."""

    def __init__(self, model: torch.nn.Module, lr: float, decay_steps: Optional[int],
                 weight_decay: float):
        self.lr, self.decay_steps = lr, decay_steps
        self.leaves = convert.jax_leaves(model)
        self.params = [model.get_parameter(leaf.name) for leaf in self.leaves]
        self.trainable = [p for p in self.params if p.requires_grad]
        self.count = 0
        self.opt = torch.optim.AdamW(self.trainable, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay)

    def learning_rate(self) -> float:
        if self.decay_steps is None:
            return self.lr
        return cosine_decay(self.lr, self.decay_steps, self.count)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.trainable:
            if p.grad is None:   # optax steps every leaf; its gradient is 0
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.learning_rate()
        self.opt.step()
        self.count += 1

    def export_state(self):
        """(Adam count, schedule count, first moments, second moments), the
        moments by parameter name (zeros before the first update, and for a
        frozen parameter)."""
        mu, nu, adam_count = {}, {}, 0
        for leaf, p in zip(self.leaves, self.params):
            st = self.opt.state.get(p, {})
            mu[leaf.name] = st.get("exp_avg", torch.zeros_like(p))
            nu[leaf.name] = st.get("exp_avg_sq", torch.zeros_like(p))
            if "step" in st:
                adam_count = int(st["step"])
        return adam_count, self.count, mu, nu

    def import_state(self, adam_count: int, sched_count: int, mu, nu) -> None:
        """The moments of the trainable parameters (a frozen one's, which a
        JAX checkpoint may hold, are left out) and both counts."""
        for leaf, p in zip(self.leaves, self.params):
            if not p.requires_grad:
                continue
            self.opt.state[p] = {
                "step": torch.tensor(float(adam_count)),
                "exp_avg": mu[leaf.name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": nu[leaf.name].to(p.device, p.dtype).clone()}
        self.count = sched_count


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module) -> AdamWCosine:
    return AdamWCosine(model, cfg.lr, cfg.epochs * cfg.steps_per_epoch,
                       cfg.weight_decay)


def make_train_step(cfg: TrainConfig, model: torch.nn.Module,
                    opt: AdamWCosine) -> Callable:
    """step(batch, marks=None) -> (loss, logs), updating the model in
    place; a request of utils/profiling whose top-level spans are forward
    (the loss included, its own span `loss`), backward and optimizer, their
    end events appended to `marks`."""

    def train_step(batch, marks=None):
        with profiling.request(marks):
            with profiling.span("forward"):
                opt.zero_grad()
                preds = model_forward(cfg, model, batch)
                with profiling.span("loss"):
                    loss, logs = losses.centersnap_loss(preds, batch)
            with profiling.span("backward"):
                loss.backward()
            with profiling.span("optimizer"):
                opt.step()
        return loss.detach(), {k: v.detach() for k, v in logs.items()}

    return train_step


def make_eval_step(cfg: TrainConfig, model: torch.nn.Module) -> Callable:
    @torch.no_grad()
    def eval_step(batch):
        return losses.centersnap_loss(model_forward(cfg, model, batch), batch)

    return eval_step


def _prepare_batch(cfg: TrainConfig, batch: Dict[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """Loader batch -> model inputs on `device`: ImageNet-normalized RGB for
    res_fpn, depth normalized to [0, 1] over 25 m (zeros for res_fpn
    without depth), pose maps stored channel-first moved to NHWC. Each
    array is uploaded from pageable memory, which makes the host wait: one
    `host_syncs` each."""

    def upload(a):
        profiling.count("host_syncs")
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    rgb = np.asarray(batch["rgb"], np.float32)
    if cfg.arch == "res_fpn":
        rgb = (rgb - _IMAGENET_MEAN) / _IMAGENET_STD
    out = {"rgb": upload(rgb), "heatmap": upload(batch["heatmap"]),
           "pose_map": upload(batch["pose_map"])}
    if "depth" in batch:
        out["depth"] = normalize_depth_fixed(upload(batch["depth"]))
    elif cfg.arch == "res_fpn":
        out["depth"] = torch.zeros(out["rgb"].shape[:3], device=device)
    if out["pose_map"].dim() == 4 and out["pose_map"].shape[1] == 12:
        out["pose_map"] = out["pose_map"].permute(0, 2, 3, 1)
    return out


def train_iteration(cfg: TrainConfig, train_step: Callable, host_batch: Dict,
                    device, marks: Optional[list] = None):
    """One iteration of `train`'s loop as one request of utils/profiling:
    the loader's batch uploaded (_prepare_batch), then `train_step` ->
    (loss, logs, the batch on `device`). `marks` receives a start event and
    the step's top-level spans' end events."""
    with profiling.request(marks, start=True):
        batch = _prepare_batch(cfg, host_batch, device)
        loss, logs = train_step(batch, marks)
    return loss, logs, batch


def _numpy(tree: Dict) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def train(cfg: TrainConfig, log_fn=print, tb_logdir: Optional[str] = None,
          device=None, on_step: Optional[Callable] = None) -> torch.nn.Module:
    """Run the training loop; returns the trained model.

    `tb_logdir`: TensorBoard scalars (and images every `vis_every` steps)
    go there. `on_step(step, loss, logs, marks)` is called after each
    training step; on CUDA `marks` holds the step's events (a start event,
    then forward, backward and optimizer)."""
    from .data import ShardedLoader

    dev = resolve_device(device)
    tb = None
    if tb_logdir:
        from .tb_writer import TBWriter
        tb = TBWriter(tb_logdir)

    model = model_init(cfg, dev)
    opt = make_optimizer(cfg, model)
    step = 0
    if cfg.resume:
        tree, step_loaded = ckpt_lib.load_train_state(cfg.resume)
        convert.load_jax_tree(model, tree)
        ckpt_lib.restore_opt_state(cfg.resume, model, opt)
        step = step_loaded or 0
        log_fn(f"resumed from {cfg.resume} at step {step}")

    train_step = make_train_step(cfg, model, opt)
    eval_step = make_eval_step(cfg, model)
    loader = ShardedLoader(cfg.train_shards, batch_size=cfg.batch_size,
                           seed=cfg.seed)
    test_loader = (ShardedLoader(cfg.test_shards, batch_size=cfg.batch_size,
                                 shuffle_buffer=1, seed=cfg.seed)
                   if cfg.test_shards else None)

    start_epoch = step // max(cfg.steps_per_epoch, 1)
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        for host_batch in loader.epoch(epoch):
            marks = [] if (on_step is not None and dev.type == "cuda") else None
            loss, logs, batch = train_iteration(cfg, train_step, host_batch, dev, marks)
            step += 1
            if on_step is not None:
                on_step(step, loss, logs, marks)
            if step % cfg.log_every == 0:
                log_fn(f"epoch {epoch} step {step}: loss={float(loss):.4f} "
                       + " ".join(f"{k}={float(v):.4f}" for k, v in logs.items()))
                if tb is not None:
                    tb.scalars({"loss/train": float(loss),
                                **{f"loss/{k}": float(v) for k, v in logs.items()}},
                               step)
                    tb.flush()
            if tb is not None and cfg.vis_every and step % cfg.vis_every == 0:
                from . import visualize as vz
                with torch.no_grad():
                    preds = _numpy(model_forward(cfg, model, batch))
                for tag, img in vz.training_visuals(_numpy(batch), preds).items():
                    tb.image(tag, img, step)
                tb.flush()

        if test_loader is not None:
            tot, n = 0.0, 0
            for batch in test_loader.epoch(0):
                loss, _ = eval_step(_prepare_batch(cfg, batch, dev))
                tot += float(loss)
                n += 1
            log_fn(f"epoch {epoch}: test loss {tot / max(n, 1):.4f} "
                   f"({time.time() - t0:.0f}s)")
            if tb is not None:
                tb.scalars({"loss/test": tot / max(n, 1)}, step)
                tb.flush()

        if (epoch + 1) % cfg.ckpt_every_epochs == 0:
            ckpt_lib.save_params(cfg.ckpt_path, model, step=step, optimizer=opt)
            log_fn(f"saved checkpoint -> {cfg.ckpt_path}")

    ckpt_lib.save_params(cfg.ckpt_path, model, step=step, optimizer=opt)
    if tb is not None:
        tb.close()
    return model
