"""Checkpoint inspection/surgery tools (port of
boxsegliver_tpu/utils/ckpt_tools.py over the port's ``state.pt`` instead of
orbax trees; reference utils/ckpt_kits.py:21-90): variable listing, name
rewriting, checkpoint discovery.

    python -m boxsegliver_torch.utils.ckpt_tools list   <ckpt dir | state.pt>
    python -m boxsegliver_torch.utils.ckpt_tools rename <in> <out.pt> \\
        --replace a:b [c:empty] [--add_prefix p]

A path is a checkpoint directory (``ckpt/<step>``, ``ckpt_best/<tag>``), a
train/checkpoint.py ``state.pt`` or a plain ``.pt`` state_dict; the
variables are the model's state_dict keys (``Encode1_conv1.weight``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from boxsegliver_torch.train.checkpoint import STATE_FILE, load_state


def _load(path) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """(the file's dict, its model state_dict)."""
    path = Path(path)
    state = load_state(path / STATE_FILE if path.is_dir() else path)
    return state, state["model"] if "model" in state else state


def list_vars(path) -> Dict[str, Tuple]:
    """name → (shape, dtype) map (reference list_vars_shape/dtype)."""
    _, model = _load(path)
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in model.items()}


def rename_keys(keys: Iterable[str], replace_from: Iterable[str] = (),
                replace_to: Iterable[str] = (),
                add_prefix: Optional[str] = None) -> Dict[str, str]:
    """old → new names (reference ckpt_vars_rename, ckpt_kits.py:36-60):
    each ``from`` substring replaced by its ``to`` in turn, 'empty' in
    replace_to deleting the substring, then ``add_prefix`` prepended."""
    replace_from = list(replace_from)
    replace_to = ["" if x == "empty" else x for x in replace_to]
    if len(replace_from) != len(replace_to):
        raise ValueError("replace_from and replace_to differ in length")
    out = {}
    for k in sorted(keys):
        new = k
        for f, t in zip(replace_from, replace_to):
            new = new.replace(f, t)
        if add_prefix:
            new = add_prefix + new
        out[k] = new
    return out


def ckpt_vars_rename(input_path, output_path=None,
                     replace_from: Iterable[str] = (),
                     replace_to: Iterable[str] = (),
                     add_prefix: Optional[str] = None
                     ) -> Dict[str, torch.Tensor]:
    """The model state_dict of ``input_path`` with its keys renamed by
    rename_keys; written to ``output_path`` in the input's layout (a
    checkpoint's other entries kept) when given."""
    state, model = _load(input_path)
    names = rename_keys(model, replace_from, replace_to, add_prefix)
    renamed = {names[k]: model[k] for k in sorted(model)}
    if len(renamed) != len(model):
        raise ValueError("the rename maps two variables to one name")
    if output_path:
        out = dict(state, model=renamed) if "model" in state else renamed
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(out, output_path)
    return renamed


def find_checkpoint(model_dir, status_file: str = "checkpoint") -> Optional[Path]:
    """Locate the newest checkpoint directory under a model dir (reference
    find_checkpoint, ckpt_kits.py:62-90): 'checkpoint' → the latest
    ``ckpt/<step>`` holding a state.pt; 'checkpoint_best[_N]' → the matching
    ``ckpt_best/<tag>``."""
    model_dir = Path(model_dir)
    if status_file.startswith("checkpoint_best"):
        tag = status_file.replace("checkpoint_", "")
        path = model_dir / "ckpt_best" / tag
        return path if (path / STATE_FILE).exists() else None
    ckpt_root = model_dir / "ckpt"
    if not ckpt_root.exists():
        return None
    steps = sorted((int(p.name) for p in ckpt_root.iterdir()
                    if p.name.isdigit() and (p / STATE_FILE).exists()),
                   reverse=True)
    return ckpt_root / str(steps[0]) if steps else None


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list")
    p.add_argument("path")
    p = sub.add_parser("rename")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--replace", nargs="*", default=[],
                   help="from:to pairs ('empty' deletes the substring)")
    p.add_argument("--add_prefix")
    args = parser.parse_args(argv)
    if args.cmd == "list":
        for k, (shape, dtype) in sorted(list_vars(args.path).items()):
            print(k, shape, dtype)
    else:
        pairs = [r.split(":", 1) for r in args.replace]
        ckpt_vars_rename(args.input, args.output,
                         [p[0] for p in pairs], [p[1] for p in pairs],
                         args.add_prefix)


if __name__ == "__main__":
    main()
