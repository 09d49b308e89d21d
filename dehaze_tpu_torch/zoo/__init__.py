"""The classification zoo on the port (counterpart of `dehaze_tpu/zoo/`):
the how-do-vits-work model families that the thesis's loss-landscape and
Fourier analyses were built on, as `nn.Module`s with the reference's
state_dict names, so its `.pth.tar` checkpoints load as they are.

    from dehaze_tpu_torch.zoo import get_model
    model = get_model("resnet_dnn_18", num_classes=10, device="cuda")
    logits = model(x_nchw)

No TPU kernel computes any zoo model: they run on plain torch (cuBLAS and
cuDNN on the card). The evaluation harness is here too: `zoo.data`
(CIFAR-10/100, CIFAR-C/-P and ImageFolder loaders, the batch transforms),
`evaluate` (the calibration metrics, `test`, `test_perturbation`,
`test_prediction_time`), `adversarial`, `fourier`, `ensemble` and
`cli.zoo`'s eval, perturbation, attack, fourier and predtime. The trainer
(`zoo/train.py` holds only `soft_ce`; `cli.zoo train` refuses) is not
ported yet.
"""

from dehaze_tpu_torch.zoo.registry import get_model, list_models  # noqa: F401
