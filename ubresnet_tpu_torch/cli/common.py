"""What the deploy CLIs (infer_precropped, infer_wholeview, serve)
share: the model their flags ask for."""
from __future__ import annotations


def load_model(args):
    """The eval model of ``args.checkpoint`` (a reference-format .tar)
    on ``args.device``, under the policy the precision flags ask for:
    ``--f32`` (TF32 off), ``--int8`` or the default bf16 kernel zone.
    The architecture is ASPP-ResNet when ``--arch aspp_resnet`` asks for
    it or the checkpoint holds ASPP keys (so the default ``--arch`` runs
    an ASPP .tar as ASPP, as the JAX package does), else UResNet. What
    the port cannot load exits."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    if args.int8 and args.f32:
        raise SystemExit("--int8 and --f32 are mutually exclusive")
    if getattr(args, "config", None) or getattr(args, "best", False):
        raise SystemExit(
            "the port does not read orbax checkpoints (--config, --best): "
            "write a reference .tar from one with the JAX package's "
            "export_torch CLI (ubresnet_tpu/cli/export_torch.py) and pass "
            "it with -c (ROADMAP queue 1 item 11)")
    device = resolve_device(args.device)
    policy = (Policy.f32() if args.f32 else
              Policy.int8() if args.int8 else Policy())
    if args.f32:
        strict_f32()
    if not args.checkpoint.endswith(".tar"):
        raise SystemExit("the port reads reference-format .tar checkpoints")
    sd, info = load_reference_checkpoint(args.checkpoint)
    arch = getattr(args, "arch", "uresnet")
    if arch == "aspp_resnet" and info["arch"] != "aspp_resnet":
        raise SystemExit(
            f"--arch aspp_resnet: {args.checkpoint} has no ASPP_layer_enc3 "
            "keys (ASPP_layer_enc3.B1_conv.weight ...); it holds a UResNet")
    return get_model(info["arch"], sd, policy=policy, device=device)
