"""What the deploy CLIs (infer_precropped, infer_wholeview, serve)
share: the model their flags ask for."""
from __future__ import annotations


def load_model(args):
    """The eval UResNet of ``args.checkpoint`` (a reference-format .tar)
    on ``args.device``, under the policy the precision flags ask for:
    ``--f32`` (TF32 off), ``--int8`` or the default bf16 kernel zone.
    What the port cannot load exits."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.utils.platform import resolve_device, strict_f32

    if args.int8 and args.f32:
        raise SystemExit("--int8 and --f32 are mutually exclusive")
    if getattr(args, "arch", "uresnet") != "uresnet":
        raise SystemExit(f"--arch {args.arch} is not ported yet (ROADMAP "
                         "queue 1 item 7)")
    if getattr(args, "config", None) or getattr(args, "best", False):
        raise SystemExit("orbax checkpoints (--config, --best) are not "
                         "ported yet (ROADMAP queue 1 item 11)")
    device = resolve_device(args.device)
    policy = (Policy.f32() if args.f32 else
              Policy.int8() if args.int8 else Policy())
    if args.f32:
        strict_f32()
    if not args.checkpoint.endswith(".tar"):
        raise SystemExit("the port reads reference-format .tar checkpoints")
    sd, _ = load_reference_checkpoint(args.checkpoint)
    return get_model("uresnet", sd, policy=policy, device=device)
