"""What the deploy CLIs (infer_precropped, infer_wholeview, serve)
share: the model their flags ask for."""
from __future__ import annotations

import os


def load_model(args):
    """The eval model of ``args.checkpoint`` on ``args.device``, under
    the policy the precision flags ask for: ``--f32`` (TF32 off),
    ``--int8`` or the default bf16 kernel zone.

    ``-c`` names a reference-format .tar, or a training checkpoint
    directory (train/checkpoint.py: ``step_<N>.tar``, ``best.tar``)
    with ``--config``, the JAX package's rule: the newest step, or
    ``best.tar`` with ``--best``; the config's model section names the
    architecture and its geometry, which the weights must match. For a
    .tar the architecture is ASPP-ResNet when ``--arch aspp_resnet``
    asks for it or the checkpoint holds ASPP keys (so the default
    ``--arch`` runs an ASPP .tar as ASPP, as the JAX package does),
    else UResNet. What the port cannot load exits."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    if args.int8 and args.f32:
        raise SystemExit("--int8 and --f32 are mutually exclusive")
    device = resolve_device(args.device)
    policy = (Policy.f32() if args.f32 else
              Policy.int8() if args.int8 else Policy())
    if args.f32:
        strict_f32()
    if os.path.isdir(args.checkpoint):
        sd, info = _from_directory(args)
    elif args.config or args.best:
        raise SystemExit(
            f"--config and --best pick from a checkpoint directory "
            f"(-c DIR holding step_<N>.tar, best.tar); {args.checkpoint} "
            "is not one")
    elif not args.checkpoint.endswith(".tar"):
        raise SystemExit("the port reads reference-format .tar checkpoints")
    else:
        sd, info = load_reference_checkpoint(args.checkpoint)
        arch = getattr(args, "arch", "uresnet")
        if arch == "aspp_resnet" and info["arch"] != "aspp_resnet":
            raise SystemExit(
                f"--arch aspp_resnet: {args.checkpoint} has no "
                "ASPP_layer_enc3 keys (ASPP_layer_enc3.B1_conv.weight ...); "
                "it holds a UResNet")
    return get_model(info["arch"], sd, policy=policy, device=device)


def _from_directory(args):
    """(state_dict, info) of the checkpoint directory ``args.checkpoint``
    that ``--config`` describes: ``best.tar`` with ``--best``, else the
    newest ``step_<N>.tar``."""
    from ubresnet_tpu_torch.core.config import TrainConfig
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.train.checkpoint import checkpoint_file

    if not args.config:
        raise SystemExit(
            f"--config required for checkpoint directories "
            f"(-c {args.checkpoint})")
    try:
        path = checkpoint_file(args.checkpoint, best=args.best)
    except FileNotFoundError as e:
        raise SystemExit(
            f"{e}: the port reads the step_<N>.tar / best.tar files its "
            "training writes; for an orbax directory of the JAX package, "
            "write a reference .tar with its export_torch CLI "
            "(ubresnet_tpu/cli/export_torch.py) and pass that with -c")
    model = TrainConfig.load(args.config).model
    sd, info = load_reference_checkpoint(path)
    want = {"arch": model.name, "inplanes": model.inplanes,
            "input_channels": model.input_channels,
            "num_classes": model.num_classes}
    got = {k: info[k] for k in want}
    if got != want:
        raise SystemExit(f"{path} holds {got}; --config {args.config} "
                         f"describes {want}")
    return sd, info
