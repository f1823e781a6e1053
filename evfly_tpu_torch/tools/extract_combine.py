"""Checkpoint surgery for the D(theta)/V(phi) recombination flow (a file
tool on the CPU; reference analog: combine_state_dicts, learner.py:435-454).

Port of ``tools/extract_combine.py`` over the port's ``.pth`` IO:

  extract   pull the origunet.* half out of a joint checkpoint as an
            UNPREFIXED pure-D state dict (usable as `joint --d-ckpt`)
  combine   merge an unprefixed D dict and an unprefixed V dict into a
            composite-keyed joint checkpoint WITHOUT any training
            (origunet.* + vitfly_vitlstm.* prefixes) — lets the protocol
            eval isolate "V(phi) driven by predicted depth" zero-shot.

  python -m evfly_tpu_torch.tools.extract_combine extract --joint J.pth --out D.pth
  python -m evfly_tpu_torch.tools.extract_combine combine --d D.pth --v V.pth --out J.pth
"""

from __future__ import annotations

import argparse

from ..models import port


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("extract")
    p.add_argument("--joint", required=True)
    p.add_argument("--prefix", default="origunet.")
    p.add_argument("--out", required=True)
    p = sub.add_parser("combine")
    p.add_argument("--d", required=True)
    p.add_argument("--v", required=True)
    p.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "extract":
        sd = port.load_state_dict(args.joint)
        out = {k[len(args.prefix):]: v for k, v in sd.items() if k.startswith(args.prefix)}
        assert out, f"no keys with prefix {args.prefix} in {args.joint}"
        port.save_state_dict(out, args.out)
        print(f"[EXTRACT] {len(out)} keys {args.prefix}* -> {args.out}")
    else:
        d = port.load_state_dict(args.d)
        v = port.load_state_dict(args.v)
        out = {f"origunet.{k}": x for k, x in d.items()}
        out.update({f"vitfly_vitlstm.{k}": x for k, x in v.items()})
        port.save_state_dict(out, args.out)
        print(f"[COMBINE] {len(d)}+{len(v)} keys -> {args.out}")
    return out


if __name__ == "__main__":
    main()
