"""CLI: inspect an h5 dataset (utils/to_h5.py's view task).

Port of ``evfly_tpu/data/package_h5.py``.  Usage:

  python -m evfly_tpu_torch.data.package_h5 <dataset_path> view

``h5py`` is imported only when a file is read, so the module imports where
h5py is not installed.
"""

from __future__ import annotations

import sys


def h5dump(path: str, group: str = "/"):
    import h5py

    def descend(obj, sep="\t"):
        if isinstance(obj, (h5py.Group, h5py.File)):
            for key in obj.keys():
                print(f"{sep}- {key}: {obj[key]}")
                descend(obj[key], sep + "\t")

    with h5py.File(path, "r") as f:
        descend(f[group])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: python -m evfly_tpu_torch.data.package_h5 <dataset> <task:view>")
        sys.exit(1)
    dataset, task = argv[0], argv[1]
    path = dataset if dataset.endswith(".h5") else dataset + ".h5"
    if task == "view":
        h5dump(path)
    else:
        print(f"Unknown task {task}")
        sys.exit(1)


if __name__ == "__main__":
    main()
