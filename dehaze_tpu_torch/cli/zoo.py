"""The classification zoo's harness CLI on the port (counterpart of
`dehaze_tpu/cli/zoo.py`; ≙ the reference's notebook and script surface,
`how-do-vits-work-transformer/`):

    eval          ≙ ops/tests.test calibration harness (+ CIFAR-C via
                    --ctype/--intensity ≙ robustness.ipynb, ImageNet(-C)
                    folders with --dataset imagenet, deep ensembles with
                    --ensemble)
    perturbation  ≙ ops/tests.test_perturbation on CIFAR-10-P
    attack        ≙ ops/adversarial.py (FGSM/PGD/Random [+ --freq band])
    fourier       ≙ fourier_analysis.ipynb + featuremap_variance.ipynb
    predtime      ≙ tests.test_prediction_time + models.stats
    train         ≙ ops/trains.train + classification.ipynb (ZooTrainer;
                  --data_axis N under torchrun: data-parallel with
                  global-batch BatchNorm, one process per GPU)

Every subcommand takes the JAX package's flags, the reference's YAML
schema through --config (eval), and --device (default cuda; a missing GPU
is an error, not a fallback). --ckpt (and each --ensemble member) takes
the JAX package's `.msgpack` or a reference `.pth`/`.pth.tar`; without
--ckpt the model keeps a seeded random init. `train` writes
`epoch_{e}.pth.tar` and `best.pth.tar` (the reference's zoo payload; the
JAX package reads them through `load_torch_zoo_checkpoint`) where the
JAX CLI writes `.msgpack`. `fourier --out_plot ''` skips the figures,
which need matplotlib, as `--out_plot ''` does in `cli.landscape`. No
kernel of the port runs here: the zoo's models are plain torch.

    python -m dehaze_tpu_torch.cli.zoo train --name vit_ti --patch_size 4 \\
        --dataset cifar10 --optimizer AdamW --lr 1e-3 --mixup --out z
    torchrun --nproc_per_node 2 -m dehaze_tpu_torch.cli.zoo train \\
        --name resnet_dnn_18 --dataset cifar10 --data_axis 2 --out z
    python -m dehaze_tpu_torch.cli.zoo eval --name vit_ti --patch_size 8 \\
        --dataset synthetic --ckpt z/best.pth.tar --json_out m.json
"""

import argparse
import json
import os
import time

import numpy as np
import torch


def _model_kwargs(args, sample_x=None):
    kw = {}
    for k in ("image_size", "patch_size", "window_size", "sd", "padding",
              "stride"):
        v = getattr(args, k, None)
        if v is not None:
            kw[k] = v
    # the transformer families carry the reference's 224 default
    # image_size (`vit.py:52`, etc.); their position tables are sized from
    # it, so without --image_size the model follows the loaded data's
    # geometry (CIFAR and synthetic 32², ImageNet eval 224²)
    if sample_x is not None:
        kw.setdefault("image_size", int(sample_x.shape[-3]))
    return kw


def _build(args, num_classes, sample_x=None, seed: int = 0):
    """The registry model of --name, its init drawn from `seed` on its
    device, in eval mode."""
    from dehaze_tpu_torch.zoo import get_model

    torch.manual_seed(seed)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    return get_model(args.name, num_classes=num_classes, stem=args.stem,
                     dtype=dtype, device=args.device,
                     **_model_kwargs(args, sample_x)).eval()


def _load(args, model, ckpt=None):
    """`ckpt` (default --ckpt) into the model; without one, keep its
    random init and say so, as the JAX CLI does."""
    from dehaze_tpu_torch.zoo.checkpoint import read_state_dict

    ckpt = ckpt or args.ckpt
    if ckpt:
        model.load_state_dict(read_state_dict(ckpt, model))
        return
    print("[zoo] no --ckpt given: using random init")


def _apply_config(args, parser):
    """Overlay the reference YAML schema (configs/cifar10_vit.yaml) under
    the explicit flags (a flag wins when it is not at its default)."""
    if not args.config:
        return args
    try:
        import yaml
    except ImportError as e:
        raise SystemExit(f"--config {args.config} needs PyYAML, which is "
                         f"not installed ({e})") from e

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    defaults = {a.dest: a.default for a in parser._actions}

    def take(dest, value):
        if value is not None and getattr(args, dest, None) == defaults.get(dest):
            setattr(args, dest, value)

    ds, tr = cfg.get("dataset", {}), cfg.get("train", {})
    opt, mb = cfg.get("optim", {}), cfg.get("model", {}).get("block", {})
    take("dataset", ds.get("name"))
    take("root", ds.get("root"))
    take("epochs", tr.get("epochs"))
    take("warmup_epochs", tr.get("warmup_epochs"))
    take("batch_size", tr.get("batch_size"))
    take("max_norm", tr.get("max_norm"))
    take("smoothing", tr.get("smoothing"))
    if tr.get("mixup") is not None and not getattr(args, "no_mixup", False):
        args.mixup_cfg = {
            "mixup_alpha": tr["mixup"].get("mixup_alpha", 1.0),
            "cutmix_alpha": tr["mixup"].get("cutmix_alpha", 0.8),
            "prob": tr["mixup"].get("prob", 1.0),
        }
    take("optimizer", opt.get("name"))
    take("lr", opt.get("lr"))
    take("weight_decay", opt.get("weight_decay"))
    if opt.get("scheduler"):
        args.scheduler_cfg = dict(opt["scheduler"])
    take("stem", cfg.get("model", {}).get("stem"))
    for k in ("image_size", "patch_size", "sd", "window_size"):
        take(k, mb.get(k))
    take("n_ff", cfg.get("val", {}).get("n_ff"))
    return args


def _common(p):
    p.add_argument("--name", required=True, help="registry model name")
    p.add_argument("--dataset", default="synthetic",
                   help="cifar10|cifar100|synthetic (eval also imagenet)")
    p.add_argument("--root", default="./data")
    p.add_argument("--config", default=None, help="reference-schema YAML")
    p.add_argument("--ckpt", default=None,
                   help="the JAX package's .msgpack or a .pth/.pth.tar")
    p.add_argument("--stem", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--n_ff", type=int, default=1,
                   help="MC forward passes (mcdo models)")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--padding", type=int, default=None)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--sd", type=float, default=None)
    p.add_argument("--n_synth", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (a missing GPU is an "
                        "error, not a fallback)")
    return p


def _device(model) -> torch.device:
    return next(model.parameters()).device


def cmd_train(args, parser):
    """≙ the JAX CLI's train (`dehaze_tpu/cli/zoo.py:154-207`): the YAML
    overlay, `warmup_epochs + epochs` epochs each shuffled with seed +
    epoch, the epoch line, `evaluate.test` on the test split and the
    checkpoints (`epoch_{e}.pth.tar`, `best.pth.tar`: the reference's zoo
    payload with acc and loss). Under torchrun (`--data_axis N`, one
    process per GPU) every rank trains on its share of each global batch
    of --batch_size rows; rank 0 evaluates and writes while the others
    wait."""
    from dehaze_tpu_torch.parallel import dist
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo import evaluate as zeval
    from dehaze_tpu_torch.zoo.checkpoint import save_file
    from dehaze_tpu_torch.zoo.train import ZooTrainer

    args = _apply_config(args, parser)
    if args.data_axis > 1 or "RANK" in os.environ:
        dist.check_world("--data_axis", args.data_axis)
        args.device = str(dist.init(args.device))
    lead = dist.rank() == 0
    (xtr, ytr), (xte, yte), nc, _ = zdata.get_dataset(
        args.dataset, args.root, n_synth=args.n_synth,
        synth_size=args.image_size)
    model = _build(args, nc, xtr, seed=args.seed)
    steps_per_epoch = max(1, len(xtr) // args.batch_size)
    mixup_cfg = getattr(args, "mixup_cfg", None)
    if mixup_cfg is None and args.mixup and not args.no_mixup:
        mixup_cfg = {"mixup_alpha": 1.0, "cutmix_alpha": 0.8, "prob": 1.0}
    trainer = ZooTrainer(
        model, num_classes=nc, optimizer_name=args.optimizer, lr=args.lr,
        weight_decay=args.weight_decay,
        scheduler=getattr(args, "scheduler_cfg", None),
        warmup_epochs=args.warmup_epochs, steps_per_epoch=steps_per_epoch,
        smoothing=args.smoothing, mixup=mixup_cfg,
        max_norm=args.max_norm, augment=not args.no_augment,
        data_parallel=dist.is_on(), seed=args.seed)
    trainer.init(xtr[:args.batch_size])

    if lead:
        os.makedirs(args.out, exist_ok=True)
    rows = len(xtr) // args.batch_size * args.batch_size
    best_acc = -1.0
    for epoch in range(args.warmup_epochs + args.epochs):
        it = zdata.batches(xtr, ytr, args.batch_size, shuffle=True,
                           seed=args.seed + epoch)
        t0 = time.perf_counter()
        loss, nll, l1, l2 = trainer.train_epoch(it)
        secs = time.perf_counter() - t0
        if lead:
            phase = "Warmup epoch" if epoch < args.warmup_epochs else "Epoch"
            print(f"{phase}: {epoch}, Loss: {loss:.4f}, lr: "
                  f"{trainer.lr():.3e}, l1: {l1:.1f}, l2: {l2:.2f}")
            print(f"  train: {secs:.3f} s, {rows / secs:.1f} img/s")
            metrics = zeval.test(model, zdata.batches(xte, yte,
                                                      args.batch_size),
                                 n_ff=args.n_ff)
            acc = metrics[3][0]
            print(f"  val: {zeval.repr_metrics(metrics)}")
            save_file(os.path.join(args.out, f"epoch_{epoch}.pth.tar"),
                      model, args.name, None, epoch,
                      extra={"acc": acc, "loss": loss})
            if acc > best_acc:
                best_acc = acc
                save_file(os.path.join(args.out, "best.pth.tar"), model,
                          args.name, None, epoch, extra={"acc": acc})
        dist.barrier()
    if lead:
        print(f"best acc: {best_acc:.4f}")
    return best_acc


def cmd_eval(args, parser):
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo import evaluate as zeval

    args = _apply_config(args, parser)
    if args.dataset == "imagenet":
        # folder-streamed (ops/datasets.py:110-139 / ops/imagenetc.py)
        size = args.image_size or 224
        if args.ctype:
            folder = os.path.join(args.root, "imagenetc", args.ctype,
                                  str(args.intensity))
            it = zdata.imagenet_c_batches(args.ctype, args.intensity,
                                          args.batch_size, root=args.root,
                                          size=size)
        else:
            folder = os.path.join(args.root, "imagenet", "val")
            it = zdata.imagenet_batches(args.batch_size, root=args.root,
                                        size=size)
        classes, _ = zdata.list_image_folder(folder)
        nc = len(classes)
        first = next(it)
        model = _build(args, nc, first[0])
        _load(args, model)

        def chain():
            yield first
            yield from it

        batch_iter = chain()
    else:
        if args.ctype:
            nc = 100 if "100" in args.dataset else 10
            x, y = zdata.load_cifar_c(args.root, args.ctype, args.intensity,
                                      "cifar100" if nc == 100 else "cifar10")
        else:
            _, (x, y), nc, _ = zdata.get_dataset(
                args.dataset, args.root, n_synth=args.n_synth,
                synth_size=args.image_size)
        model = _build(args, nc, x)
        _load(args, model)
        batch_iter = zdata.batches(x, y, args.batch_size)
    if getattr(args, "ensemble", None):
        from dehaze_tpu_torch.zoo.checkpoint import read_state_dict
        from dehaze_tpu_torch.zoo.ensemble import (Ensemble,
                                                   stack_state_dicts)

        dev = _device(model)
        members = [model.state_dict()] + [
            {k: v.to(dev) for k, v in read_state_dict(ck, model).items()}
            for ck in args.ensemble]
        model = Ensemble.stacked(model, stack_state_dicts(members))
        print(f"[zoo] deep ensemble of {len(members)} members")
    metrics = zeval.test(model, batch_iter, n_ff=args.n_ff,
                         fig_path=args.fig)
    print(zeval.repr_metrics(metrics))
    if args.metrics_csv:
        key = args.ctype or args.dataset
        zeval.save_metrics(args.metrics_csv, [[key, *metrics]])
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"nll": metrics[0], "acc": metrics[3][0],
                       "acc90": metrics[3][1], "top5": metrics[7],
                       "brier": metrics[8], "ece": metrics[12],
                       "ecse": metrics[13]}, f)
    return metrics


def cmd_perturbation(args, parser):
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo import evaluate as zeval

    x = zdata.load_cifar_p(args.root, args.ptype)
    model = _build(args, 10, x[0])
    _load(args, model)
    seqs = (x[i:i + args.batch_size] for i in range(0, len(x),
                                                    args.batch_size))
    cons, cec = zeval.test_perturbation(model, seqs, n_ff=args.n_ff)
    print(f"ptype: {args.ptype}, consistency: {cons:.4f}, CEC: {cec:.4f}")
    return cons, cec


def cmd_attack(args, parser):
    from dehaze_tpu_torch.zoo import adversarial as adv
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo.evaluate import to_nchw

    _, (x, y), nc, _ = zdata.get_dataset(
        args.dataset, args.root, n_synth=args.n_synth,
        synth_size=args.image_size)
    x, y = x[: args.n_examples], y[: args.n_examples]
    model = _build(args, nc, x)
    _load(args, model)
    dev = _device(model)
    xs = to_nchw(x, dev).contiguous()
    ys = torch.as_tensor(y).to(dev)

    def generator():
        return torch.Generator().manual_seed(args.seed)

    def acc_of(images):
        with torch.inference_mode():
            logits = model(images, generators={"dropout": generator()})
        return float(np.mean(np.argmax(logits.float().cpu().numpy(), -1)
                             == y))

    if args.method == "fgsm":
        x_adv, _ = adv.fgsm(model, xs, ys, eps=args.eps, n_ff=args.n_ff,
                            generator=generator())
    elif args.method == "pgd":
        x_adv, _ = adv.pgd(model, xs, ys, eps=args.eps, alpha=args.alpha,
                           steps=args.steps, n_ff=args.n_ff,
                           generator=generator())
    elif args.method == "random":
        x_adv, _ = adv.random_attack(xs, ys, eps=args.eps,
                                     generator=generator())
    else:
        raise SystemExit(f"unknown method {args.method}")
    if args.freq is not None:
        x_adv = xs + adv.freq_mask(x_adv - xs, args.freq)
    clean, attacked = acc_of(xs), acc_of(x_adv)
    print(f"method: {args.method}, eps: {args.eps}, clean acc: {clean:.4f}, "
          f"adv acc: {attacked:.4f}")
    return {"clean": clean, "adv": attacked, "x_adv": x_adv}


def cmd_fourier(args, parser):
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo import fourier as zf

    _, (x, y), nc, _ = zdata.get_dataset(
        args.dataset, args.root, n_synth=args.n_synth,
        synth_size=args.image_size)
    model = _build(args, nc, x)
    _load(args, model)
    latents = zf.collect_latents(model, x[: args.batch_size])
    deltas = zf.fourier_latents(latents)
    variances = zf.variance_latents(latents)
    highfreq = zf.high_freq_deltas(latents)
    os.makedirs(args.out, exist_ok=True)
    np.savetxt(os.path.join(args.out, "highfreq_delta.csv"), highfreq,
               delimiter=",")
    np.savetxt(os.path.join(args.out, "variance.csv"), variances,
               delimiter=",")
    figs = args.out if args.out_plot is None else args.out_plot
    if figs:
        os.makedirs(figs, exist_ok=True)
        zf.save_fourier_plot(deltas, os.path.join(figs, "fourier.png"),
                             title=args.name)
        zf.save_variance_plot(variances, os.path.join(figs, "variance.png"),
                              title=args.name)
        print(f"{len(latents)} latents -> {figs}/fourier.png, variance.png")
    else:
        print(f"{len(latents)} latents -> {args.out}/highfreq_delta.csv, "
              f"variance.csv (no figures)")
    print("highfreq_delta:", np.round(highfreq, 3))
    return {"latents": latents, "deltas": deltas, "variances": variances}


def cmd_predtime(args, parser):
    """≙ `tests.test_prediction_time` + `models.stats`/`count_parameters`
    (`tests.py:206-223`, `models/__init__.py:397-423`)."""
    from dehaze_tpu_torch.zoo import checkpoint as zckpt
    from dehaze_tpu_torch.zoo import data as zdata
    from dehaze_tpu_torch.zoo import evaluate as zeval

    _, (x, _y), nc, _ = zdata.get_dataset(
        args.dataset, args.root, n_synth=args.n_synth,
        synth_size=args.image_size)
    model = _build(args, nc, x)
    _load(args, model)
    dev = _device(model)
    size = (args.batch_size,) + x.shape[1:]
    zckpt.stats(model, zeval.to_nchw(x[:1], dev), name=args.name,
                generators={"dropout": torch.Generator(dev).manual_seed(0)})
    meter = zeval.test_prediction_time(model, input_size=size, n=args.n,
                                       n_ff=args.n_ff)
    imgs_per_s = args.batch_size / meter.avg
    print(f"throughput: {imgs_per_s:.1f} img/s at batch {args.batch_size}")
    return {"seconds": meter.avg, "img_per_s": imgs_per_s}


def build_parsers():
    """Top-level parser + per-subcommand parsers (the latter are needed by
    `_apply_config` to know each flag's default)."""
    top = argparse.ArgumentParser(description="classification zoo harness")
    sub = top.add_subparsers(dest="cmd", required=True)

    pt = _common(sub.add_parser("train"))
    pt.add_argument("--epochs", type=int, default=1)
    pt.add_argument("--warmup_epochs", type=int, default=0)
    pt.add_argument("--optimizer", default="SGD")
    pt.add_argument("--lr", type=float, default=0.1)
    pt.add_argument("--weight_decay", type=float, default=0.0)
    pt.add_argument("--max_norm", type=float, default=None)
    pt.add_argument("--smoothing", type=float, default=0.0)
    pt.add_argument("--mixup", action="store_true", default=False,
                    help="enable mixup/cutmix with the config defaults")
    pt.add_argument("--no_mixup", action="store_true", default=False)
    pt.add_argument("--no_augment", action="store_true", default=False)
    pt.add_argument("--data_axis", type=int, default=1,
                    help="data parallelism over N devices")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--out", default="zoo_ckpts")

    pe = _common(sub.add_parser("eval"))
    pe.add_argument("--ctype", default=None, help="CIFAR-C corruption type")
    pe.add_argument("--intensity", type=int, default=1)
    pe.add_argument("--fig", default=None, help="reliability-diagram path")
    pe.add_argument("--ensemble", nargs="+", default=None, metavar="CKPT",
                    help="additional member checkpoints: evaluate the deep "
                         "ensemble of --ckpt + these (one architecture, "
                         "stacked weights)")
    pe.add_argument("--json_out", default=None)
    pe.add_argument("--metrics_csv", default=None,
                    help="flattened metric row CSV (≙ tests.save_metrics)")

    pp = _common(sub.add_parser("perturbation"))
    pp.add_argument("--ptype", default="gaussian_noise")

    pa = _common(sub.add_parser("attack"))
    pa.add_argument("--method", default="fgsm",
                    choices=["fgsm", "pgd", "random"])
    pa.add_argument("--eps", type=float, default=0.007)
    pa.add_argument("--alpha", type=float, default=2 / 255)
    pa.add_argument("--steps", type=int, default=40)
    pa.add_argument("--freq", type=float, default=None,
                    help="band-pass the perturbation at this frequency")
    pa.add_argument("--n_examples", type=int, default=128)
    pa.add_argument("--seed", type=int, default=0)

    pf = _common(sub.add_parser("fourier"))
    pf.add_argument("--out", default="zoo_fourier")
    pf.add_argument("--out_plot", default=None,
                    help="directory of fourier.png and variance.png "
                         "(default: --out); '' skips the figures, which "
                         "need matplotlib")

    pd = _common(sub.add_parser("predtime"))
    pd.add_argument("--n", type=int, default=100,
                    help="timed predictions (tests.py:206 n=100)")

    return top, {"train": pt, "eval": pe, "perturbation": pp, "attack": pa,
                 "fourier": pf, "predtime": pd}


def main(argv=None):
    top, parsers = build_parsers()
    args = top.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval,
            "perturbation": cmd_perturbation, "attack": cmd_attack,
            "fourier": cmd_fourier,
            "predtime": cmd_predtime}[args.cmd](args, parsers[args.cmd])


if __name__ == "__main__":
    from dehaze_tpu_torch.parallel import dist

    main()
    dist.shutdown()
