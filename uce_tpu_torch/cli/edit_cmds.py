"""``python -m uce_tpu_torch edit-flux`` and ``edit-hidream``: the
closed-form FLUX.1 and HiDream-I1 edits (reference
trainscripts/uce_flux_edit.py and uce_hidream_edit.py;
uce_tpu/cli/edit_cmds.py)."""

from __future__ import annotations

from uce_tpu_torch.utils.prompts import resolve_edit_request


def register_cli(sub, add_edit_flags) -> None:
    p = sub.add_parser("edit-flux", help="closed-form edit for FLUX.1 (dev/schnell)")
    add_edit_flags(p, "black-forest-labs/FLUX.1-schnell")
    p.add_argument("--max_sequence_length", type=int, default=None,
                   help="default: 256 for schnell, 512 otherwise")
    p.set_defaults(func=_cmd_flux)
    p = sub.add_parser("edit-hidream", help="closed-form edit for HiDream-I1")
    add_edit_flags(p, "HiDream-ai/HiDream-I1-Full")
    p.add_argument("--llama_dir", type=str, default=None,
                   help="local snapshot of Meta-Llama-3.1-8B-Instruct (default: the "
                        "snapshot's text_encoder_4)")
    p.add_argument("--max_sequence_length", type=int, default=128)
    p.set_defaults(func=_cmd_hidream)


def _reject_sd_only_flags(args, family: str) -> None:
    """--method/--apply_on come from the shared flag set but only the SD/SDXL
    path implements them; an explicitly requested non-default must error,
    not be silently dropped."""
    if args.method != "collapsed":
        raise SystemExit(
            f"--method {args.method} is not supported for {family} edits (the "
            "per-stream solve always uses the collapsed solve)")
    if args.apply_on != "device":
        raise SystemExit(f"--apply_on {args.apply_on} is not supported for {family} "
                         "edits")


def _request(args, family: str):
    """Refuse the SD-only flags, then the device and the resolved concepts."""
    from uce_tpu_torch.cli.main import resolve_device

    _reject_sd_only_flags(args, family)
    device = resolve_device(args.device)
    edits, guides, preserves = resolve_edit_request(
        args.edit_concepts, args.guide_concepts, args.preserve_concepts,
        args.concept_type, args.expand_prompts == "true")
    print(f"\n\nErasing: {edits}\n")
    print(f"Guiding: {guides}\n")
    print(f"Preserving: {preserves}\n")
    return device, edits, guides, preserves


def _cmd_flux(args) -> int:
    from uce_tpu_torch.edit import flux as edit_flux

    device, edits, guides, preserves = _request(args, "FLUX")
    res = edit_flux.load_resources(args.model_id, args.max_sequence_length, device=device)
    edit_flux.run_erase(res, edits, guides, preserves, erase_scale=args.erase_scale,
                        preserve_scale=args.preserve_scale, lamb=args.lamb,
                        save_dir=args.save_dir, exp_name=args.exp_name)
    return 0


def _cmd_hidream(args) -> int:
    from uce_tpu_torch.edit import hidream as edit_hd

    device, edits, guides, preserves = _request(args, "HiDream")
    res = edit_hd.load_resources(args.model_id, args.llama_dir, args.max_sequence_length,
                                 device=device)
    edit_hd.run_erase(res, edits, guides, preserves, erase_scale=args.erase_scale,
                      preserve_scale=args.preserve_scale, lamb=args.lamb,
                      save_dir=args.save_dir, exp_name=args.exp_name)
    return 0
