"""Checkpoint surgery CLI: inspect / rename state_dict keys.

Port of ``evfly_tpu/utils/checkpoint_surgery.py`` over the port's ``.pth``
IO (``models.port``): utils/rename_model_key.py parity,

  python -m evfly_tpu_torch.utils.checkpoint_surgery --pth_file m.pth \\
      [--old_key a.weight --new_key b.weight] [--save out.pth]

and prefix renames (``--old_prefix origunet. --new_prefix ''``), the common
surgery when moving weights between single and composite models.  A file
tool: it runs on the CPU.
"""

from __future__ import annotations

import argparse

from ..models import port


def main(argv=None):
    ap = argparse.ArgumentParser(description="Inspect/rename .pth state_dict keys")
    ap.add_argument("--pth_file", type=str, required=True)
    ap.add_argument("--old_key", type=str, default=None)
    ap.add_argument("--new_key", type=str, default=None)
    ap.add_argument("--old_prefix", type=str, default=None)
    ap.add_argument("--new_prefix", type=str, default=None)
    ap.add_argument("--save", type=str, default=None)
    args = ap.parse_args(argv)

    sd = port.load_state_dict(args.pth_file)

    print("Current state_dict keys and values:")
    for k, v in sd.items():
        print(f"{k}: {type(v).__name__} - {getattr(v, 'shape', '')}")

    changed = False
    if args.old_key is not None and args.new_key is not None:
        if args.old_key in sd:
            sd[args.new_key] = sd.pop(args.old_key)
            print(f"\nRenamed key '{args.old_key}' to '{args.new_key}'.")
            changed = True
        else:
            print(f"Key '{args.old_key}' not found in state_dict.")
    if args.old_prefix is not None and args.new_prefix is not None:
        renamed = {}
        for k, v in sd.items():
            if k.startswith(args.old_prefix):
                renamed[args.new_prefix + k[len(args.old_prefix):]] = v
                changed = True
            else:
                renamed[k] = v
        sd = renamed
        print(f"\nRenamed prefix '{args.old_prefix}' -> '{args.new_prefix}'.")

    if args.save is not None:
        port.save_state_dict(sd, args.save)
        print(f"{'Modified' if changed else 'Unmodified'} checkpoint saved to {args.save}")
    return sd


if __name__ == "__main__":
    main()
