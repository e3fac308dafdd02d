"""CenterSnap training cells: one request is one iteration of the
training loop of `python -m hunyuanworld_mirror_tpu_torch.train`.

The cell builds the trainer's configuration through the CLI itself
(train.parser and train.config on the file's `--backbone`, `--depth-cond`,
image and patch size, batch, rate, decay and epochs; the published
configuration is `--backbone dinov3_vits16 --depth-cond` with every other
flag at its default), checks the model's other widths against the file,
builds the model through trainer.model_init,
then loads the weights reference/centersnap.py draws from the seed, and
builds trainer.make_optimizer's AdamW and make_train_step's step. A
request is trainer.train_iteration on a host batch of the traffic's pool
(the loader's layout; request i takes batch i mod pool): the batch's
uploads, the step (forward with the loss, backward, AdamW), then a
synchronise. The program must freeze the DINO backbone: a program that
trains it, or lacks train_iteration, is refused at set-up.

Set-up runs the first `check_steps` steps (step t on batch t) through the
same call and keeps, for the check: the first step's intermediates of the
trunk and the heads' outputs (forward hooks), its loss and its gradients
of the heads' leaves (these tensors in host memory, so the window's peak
allocation is the program's alone), each trainable leaf's first gradient
norm (AdamWCosine fills a zero gradient for a leaf the loss misses) and
its change over the steps, and (in host memory too) the trainable leaves
at the start and after the steps and each step's gradients of them.
`close`, once the window and the traced steps
have run, counts the frozen leaves that moved since set-up, then frees
the program.

The check follows the same steps with the plain reference
(reference/centersnap.py, f32, TF32 off) from the same weights, and runs
its f32 heads and loss, differentiated, on the program's own first
intermediates (the program's trunk is bf16, whose rounding would hide an
f32 fault in the heads or the loss). It compares:
- trunk_gap: the reference's f32 backbone and trunk on the first batch
  against the program's bf16 intermediates, ||a - r|| / ||r||, worst
  layer;
- heads_gap: the reference's heads on the program's intermediates against
  its heatmap and pose map, max |a - r| / max |r|, worst of the two;
- loss_gap: the reference's loss of those heads against the program's
  first loss, relative;
- heads_grad_gap: the reference's gradient of each head leaf there
  against the program's first one, ||a - r|| against the larger of ||r||
  and the median head leaf's;
- grad_gap: each trunk leaf's (the trainable ones outside the heads)
  first gradient norm against the reference's on its own f32 trunk,
  against the larger of the reference's norm of that leaf and of the
  median trunk leaf (the refine check's measure);
- change_gap: the same measure of each trainable leaf's change over the
  steps, for the leaves whose reference gradient is over a thousandth of
  the median's;
- adamw_gap: the reference's AdamW (its rate, betas, eps and decoupled
  decay) stepped from the seeded weights on the program's own gradients
  of each checked step, against the program's trainable leaves after
  those steps, ||a - r|| / ||r||, worst leaf: the optimizer judged apart
  from the trunk's rounding;
- frozen_moved: how many of the frozen backbone's leaves differ at all
  from their seeded values once the window and the traced steps have
  run: a count, so any move reads at least 1 (limit 0.5).
"""

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from wmbench.frozen import centersnap_arith
from wmbench.reference import centersnap as ref
from wmbench.reference.precision import CONTROL, REFERENCE, Precision, f32_exact
from wmbench.systems import gsplat_refine as gsr
from wmbench.systems import worldmirror as wmb

OUTPUTS = ("heatmap", "pose_map")


def port_config(cfg: dict, batch: int):
    """The trainer's TrainConfig as the CLI builds it from the file's
    settings that it takes as flags (those of the published configuration
    are its defaults), the model's other widths checked against the
    file."""
    from hunyuanworld_mirror_tpu_torch import train as cli
    from hunyuanworld_mirror_tpu_torch.training import trainer
    if not (hasattr(cli, "BACKBONES") and hasattr(trainer, "train_iteration")):
        raise RuntimeError("the program's trainer cannot name a backbone or run one "
                           "iteration of its loop (train.BACKBONES, trainer.train_iteration)")
    args = ["--train-shards", "", "--backbone", cfg["encoder"], "--img-size",
            str(cfg["img_size"]), "--patch-size", str(cfg["patch_size"]), "--batch-size",
            str(batch), "--lr", repr(cfg["lr"]), "--weight-decay", repr(cfg["weight_decay"]),
            "--epochs", str(cfg["epochs"])] + (["--depth-cond"] if cfg["depth_cond"] else [])
    tc = cli.config(cli.parser().parse_args(args))
    mc = tc.model
    vgt, vit = mc.vgt, mc.vgt.vit_config
    stated = {
        "img_size": mc.img_size, "patch_size": mc.patch_size, "embed_dim": mc.embed_dim,
        "trunk_depth": mc.trunk_depth, "trunk_heads": mc.trunk_heads,
        "depth_cond": mc.use_depth_condition, "head_features": mc.heatmap_features,
        "head_out_channels": list(mc.heatmap_head.out_channels),
        "pose_down_ratio": mc.pose_down_ratio, "qk_norm": vgt.qk_norm,
        "rope_freq": vgt.rope_freq, "trunk_init_values": vgt.init_values,
        "mlp_ratio": vgt.mlp_ratio, "intermediate_idxs": list(vgt.intermediate_idxs),
        "num_register_tokens": vgt.num_register_tokens, "encoder_dim": vit.embed_dim,
        "encoder_depth": vit.depth, "encoder_heads": vit.num_heads,
        "encoder_init_values": vit.init_values, "encoder_rope_freq": vit.rope_freq,
        "batch_size": tc.batch_size, "lr": tc.lr, "weight_decay": tc.weight_decay,
        "schedule_steps": tc.epochs * tc.steps_per_epoch}
    want = {k: cfg[k] for k in stated}
    if stated != want or not vit.use_rope or vit.use_pos_embed or batch != cfg["batch_size"]:
        raise ValueError(f"the program's settings {stated} differ from the file's {want}")
    if list(mc.pose_head.out_channels) != cfg["head_out_channels"]:
        raise ValueError("the pose head's widths are not the file's")
    return tc


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.float())) for k, v in tree.items()}


def _head_leaf(name: str) -> bool:
    return name.startswith(ref.HEADS)


def _to(tree, device):
    """The tensors of nested lists and dicts `tree`, on `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def compare(readings: Dict, first: Dict, follow: Dict, own: Dict) -> Dict[str, float]:
    """The check's numbers: `readings` (losses, grad_norms, change_norms,
    frozen_moved) and `first` (the first step's tokens, preds and head
    gradients) of the program, or of the control in its place, against the
    reference's `follow` and `own`, its heads, loss and head gradients on
    `first`'s tokens."""
    gn, dn = _norms(follow["grad1"]), _norms(follow["delta"])
    trunk = [k for k in gn if not _head_leaf(k)]
    t_med = float(np.median([gn[k] for k in trunk]))
    g_med = float(np.median(list(gn.values())))
    moved = [k for k in gn if gn[k] >= 1e-3 * g_med]
    d_med = float(np.median([dn[k] for k in moved]))
    hn = _norms(own["grads"])
    h_med = float(np.median(list(hn.values())))
    return {
        "trunk_gap": max(wmb._rel_norm(a, r)
                         for a, r in zip(first["tokens"], follow["tokens"])),
        "heads_gap": max(wmb._rel_max(first["preds"][k], own["preds"][k]) for k in OUTPUTS),
        "loss_gap": gsr._gap(readings["losses"][0], own["loss"], 0.0),
        "heads_grad_gap": max(
            float(torch.linalg.norm(first["head_grads"][k] - g)) / max(hn[k], h_med, 1e-30)
            for k, g in own["grads"].items()),
        "grad_gap": max(gsr._gap(readings["grad_norms"][k], gn[k], t_med) for k in trunk),
        "change_gap": max(gsr._gap(readings["change_norms"][k], dn[k], d_med) for k in moved),
        "frozen_moved": float(readings["frozen_moved"]),
    }


def adamw_gap(cfg: dict, steps: Dict) -> float:
    """The reference's AdamW under its cosine rate, stepped from `steps`'
    start on the gradients of each of its steps, against its leaves at the
    end: ||a - r|| / ||r||, worst leaf. The gradients are the program's
    own, so the trunk's rounding does not enter."""
    params = {k: v.clone() for k, v in steps["start"].items()}
    state: Dict = {}
    for t, grads in enumerate(steps["grads"], 1):
        ref.adamw(params, grads, state, ref.learning_rate(cfg, t - 1), cfg["weight_decay"], t,
                  tuple(cfg["adam_betas"]), cfg["adam_eps"])
    return max(wmb._rel_norm(steps["end"][k], r) for k, r in params.items())


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _reference(cfg: dict, sd: Dict, batches: List[Dict], first: Dict) -> tuple:
    """The reference's follow of `batches`, and its heads, loss and head
    gradients on `first`'s intermediates of the first batch."""
    f32_exact()
    follow = ref.follow(cfg, sd, batches, REFERENCE)
    dev = first["tokens"][0].device
    b = ref.prepare(batches[0], dev)
    H, W = b["rgb"].shape[1:3]
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items() if _head_leaf(k)}
    preds = ref.heads({**sd, **leaves}, cfg, first["tokens"], H, W)
    value = ref.loss(preds, b)
    grads = torch.autograd.grad(value, list(leaves.values()))
    own = {"preds": {k: v.detach() for k, v in preds.items()}, "loss": float(value.detach()),
           "grads": dict(zip(leaves, grads))}
    return follow, own


class Cell:
    """One CenterSnap training cell on `device`."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, gen):
        from hunyuanworld_mirror_tpu_torch.training import trainer
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.units_per_request = 1
        self.check_requests: List[int] = []
        self.keep_profiled = False
        self.log = print
        self._trainer = trainer
        self.tcfg = port_config(cfg, traffic["batch"])
        self.model = trainer.model_init(self.tcfg, self.device)
        self.model.load_state_dict(ref.make_weights(cfg, seed, self.device), strict=True)
        params = dict(self.model.named_parameters())
        frozen = sorted(n for n, p in params.items() if not p.requires_grad)
        if frozen != sorted(n for n in params if ref.frozen(n)):
            raise RuntimeError("the program does not freeze exactly the DINO backbone")
        self.opt = trainer.make_optimizer(self.tcfg, self.model)
        if {id(p) for p in self.opt.opt.param_groups[0]["params"]} != {
                id(p) for p in params.values() if p.requires_grad}:
            raise RuntimeError("the optimizer does not step exactly the trainable leaves")
        self.step_fn = trainer.make_train_step(self.tcfg, self.model, self.opt)
        self.batches = gen.make(traffic, seed)["batches"]
        self.frozen0 = {n: params[n].detach().clone() for n in frozen}

        # the first steps, through the window's own call, for the check
        first: Dict = {}

        def keep_tokens(_mod, _inp, out):
            first["tokens"] = [t.detach() for t in out[0]]

        def keep_preds(_mod, _inp, out):
            first["preds"] = {k: out[k].detach() for k in OUTPUTS}

        hooks = [self.model.encoder.register_forward_hook(keep_tokens),
                 self.model.register_forward_hook(keep_preds)]
        trainable = {n: p for n, p in params.items() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in trainable.items()}
        losses, grad_norms, grads = [], None, []
        for t in range(cfg["check_steps"]):
            losses.append(float(self._step(t, None)))
            grads.append(_host({n: p.grad for n, p in trainable.items()}))
            if t == 0:
                for h in hooks:
                    h.remove()
                grad_norms = _norms({n: p.grad for n, p in trainable.items()})
                first["head_grads"] = {n: p.grad.detach().clone()
                                       for n, p in trainable.items() if _head_leaf(n)}
        self.readings = {"losses": losses, "grad_norms": grad_norms,
                         "change_norms": _norms({n: p.detach() - start[n]
                                                 for n, p in trainable.items()})}
        self.first = _to(first, "cpu")   # host memory: the window's peak is the program's
        self.steps = {"start": _host(start), "grads": grads, "end": _host(trainable)}
        del start

    def _step(self, i: int, marks):
        loss, _, _ = self._trainer.train_iteration(
            self.tcfg, self.step_fn, self.batches[i % len(self.batches)], self.device, marks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return loss

    def request(self, i: int, marks: Optional[list] = None) -> None:
        self._step(i, marks)

    def counters(self) -> str:
        from hunyuanworld_mirror_tpu_torch.ops.attention import attention
        return (f"K1 launches {attention.launches}, backward replays "
                f"{attention.backward_replays}, {self.opt.count} optimizer steps")

    def work(self) -> Dict:
        """A step's operations by dtype, by the benchmark's own count."""
        flops = centersnap_arith.step_flops(self.cfg, self.traffic["batch"])
        return {"flops_bf16": flops["bf16"], "flops_f32": flops["f32"]}

    def close(self) -> None:
        """Count the frozen leaves that moved, then free the program."""
        params = dict(self.model.named_parameters())
        self.readings["frozen_moved"] = sum(not torch.equal(params[n], v)
                                            for n, v in self.frozen0.items())
        self.model = self.opt = self.step_fn = self.frozen0 = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        sd = ref.make_weights(self.cfg, self.seed, self.device)
        steps = [self.batches[t % len(self.batches)] for t in range(self.cfg["check_steps"])]
        first = _to(self.first, self.device)
        follow, own = _reference(self.cfg, sd, steps, first)
        self.log(f"check: losses {self.readings['losses']} (program), "
                 f"{follow['losses']} (reference), {own['loss']} (its heads on the "
                 f"program's intermediates)")
        return {**compare(self.readings, first, follow, own),
                "adamw_gap": adamw_gap(self.cfg, _to(self.steps, self.device))}


def build(cfg: dict, traffic: dict, seed: int, device, gen) -> Cell:
    return Cell(cfg, traffic, seed, device, gen)


def control_numbers(cfg: dict, traffic: dict, seed: int, device, gen,
                    prec: Precision = CONTROL) -> Dict[str, float]:
    """The check's numbers with the reference at `prec` in the program's
    place, on the first steps of `seed`'s pool."""
    f32_exact()
    batches = gen.make(traffic, seed)["batches"]
    steps = [batches[t % len(batches)] for t in range(cfg["check_steps"])]
    sd = ref.make_weights(cfg, seed, torch.device(device))
    ctl = ref.follow(cfg, sd, steps, prec)
    readings = {"losses": ctl["losses"], "grad_norms": _norms(ctl["grad1"]),
                "change_norms": _norms(ctl["delta"]), "frozen_moved": 0}
    first = {"tokens": ctl["tokens"], "preds": ctl["preds"],
             "head_grads": {k: g for k, g in ctl["grad1"].items() if _head_leaf(k)}}
    optimizer = {"start": {k: sd[k] for k in ctl["delta"]}, "grads": ctl["grads"],
                 "end": ctl["end"]}
    del ctl
    follow, own = _reference(cfg, sd, steps, first)
    return {**compare(readings, first, follow, own), "adamw_gap": adamw_gap(cfg, optimizer)}
