"""Find training workspaces whose config matches search strings.

A copy of ``evfly_tpu/utils/search_logs.py`` (plain Python, no numpy or
torch), kept the same code (``tests/test_torch_tools_utils.py`` checks it):
scan a logs directory for workspaces whose saved ``config.txt`` (or
``args.txt``) contains every given string.

  python -m evfly_tpu_torch.utils.search_logs <logs_dir> <string> [<string> ...]
"""

from __future__ import annotations

import os
import sys


def file_contains_strings(path: str, strings) -> bool:
    try:
        with open(path) as f:
            content = f.read()
        return all(s in content for s in strings)
    except (FileNotFoundError, IsADirectoryError):
        return False


def search_log_dirs(root_dir: str, search_strings) -> list:
    hits = []
    for log_dir in sorted(os.listdir(root_dir)):
        p = os.path.join(root_dir, log_dir)
        if not os.path.isdir(p):
            continue
        for cfg_name in ("config.txt", "args.txt"):
            if file_contains_strings(os.path.join(p, cfg_name), search_strings):
                hits.append(log_dir)
                break
    return hits


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    for hit in search_log_dirs(sys.argv[1], sys.argv[2:]):
        print(hit)


if __name__ == "__main__":
    main()
