"""The classification zoo on the port (counterpart of `dehaze_tpu/zoo/`):
the how-do-vits-work model families that the thesis's loss-landscape and
Fourier analyses were built on, as `nn.Module`s with the reference's
state_dict names, so its `.pth.tar` checkpoints load as they are.

    from dehaze_tpu_torch.zoo import get_model
    model = get_model("resnet_dnn_18", num_classes=10, device="cuda")
    logits = model(x_nchw)

No TPU kernel computes any zoo model: they run on plain torch (cuBLAS and
cuDNN on the card). The harness is here too: `zoo.data` (CIFAR-10/100,
CIFAR-C/-P and ImageFolder loaders, the batch transforms), `evaluate`
(the calibration metrics, `test`, `test_perturbation`,
`test_prediction_time`), `adversarial`, `fourier`, `ensemble`, the
trainer `zoo.train` (the schedules, the optimizers with the JAX package's
optax semantics, `ZooTrainer`, data-parallel with global-batch BatchNorm)
and every subcommand of `cli.zoo`.
"""

from dehaze_tpu_torch.zoo.registry import get_model, list_models  # noqa: F401
