"""CenterSnap 6D-pose training CLI: the twin of tools/train.py on the GPU.

WDS shards -> CenterSnap (or the ResNet-FPN baseline, --arch res_fpn) ->
100 MSE(heatmap) + masked L1(pose map), AdamW under a cosine schedule, a
test pass every epoch, checkpoints in the JAX package's npz layout (either
package resumes the other's with --resume). Same flags and defaults as
tools/train.py:

  python -m hunyuanworld_mirror_tpu_torch.train \\
      --train-shards 'data/train-{000000..000009}.tar' \\
      --test-shards 'data/test-*.tar' --epochs 10

plus `--backbone`, the fork's choice of patch encoder (default `conv`, the
JAX CLI's). The fork's published configuration (train.py:161-167: a
frozen DINOv3 ViT-S/16 under the depth-conditioned trunk, B=20, 384 px,
AdamW 5e-5 / 0.05 under the cosine schedule) is

  python -m hunyuanworld_mirror_tpu_torch.train --train-shards ... \\
      --backbone dinov3_vits16 --depth-cond

Runs on CUDA; `main(argv, device="cpu")` runs the plain path on the CPU.
"""

import argparse
from typing import Optional


# --backbone -> CenterSnapConfig.patch_embed
BACKBONES = ("conv", "dinov3_vits16")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CenterSnap 6D-pose training (GPU)")
    p.add_argument("--train-shards", required=True)
    p.add_argument("--test-shards", default="")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--img-size", type=int, default=384)
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--depth-cond", action="store_true",
                   help="condition the trunk on the depth channel")
    p.add_argument("--backbone", choices=BACKBONES, default="conv",
                   help="patch encoder: a conv patchify, or a frozen DINOv3 ViT-S/16")
    p.add_argument("--arch", choices=("transformer", "res_fpn"),
                   default="transformer",
                   help="res_fpn = the ResNet-FPN panoptic baseline")
    p.add_argument("--ckpt", default="checkpoints/centersnap.npz")
    p.add_argument("--ckpt-every-epochs", type=int, default=2)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def config(args):
    """The TrainConfig tools/train.py builds from the same arguments (and
    --backbone, which it lacks, as the model's patch_embed)."""
    from .models import centersnap, panoptic
    from .training import trainer
    if args.arch == "res_fpn":
        model_cfg = panoptic.PanopticConfig()
    else:
        model_cfg = centersnap.CenterSnapConfig(
            img_size=args.img_size, patch_size=args.patch_size,
            patch_embed=args.backbone, use_depth_condition=args.depth_cond)
    return trainer.TrainConfig(
        train_shards=args.train_shards, test_shards=args.test_shards,
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, ckpt_path=args.ckpt,
        ckpt_every_epochs=args.ckpt_every_epochs, resume=args.resume,
        seed=args.seed, arch=args.arch, model=model_cfg)


def main(argv: Optional[list] = None, device=None, on_step=None, log_fn=print):
    """Parse `argv` (sys.argv by default) and train; returns the model.
    `on_step` and `log_fn` go to training.trainer.train."""
    from .training import trainer
    args = parser().parse_args(argv)
    return trainer.train(config(args), log_fn=log_fn, device=device,
                         on_step=on_step)


if __name__ == "__main__":
    main()
