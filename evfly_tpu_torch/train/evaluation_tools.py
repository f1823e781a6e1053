"""Offline evaluation plots & gif rendering (evaluation_tools.py parity).

* ``eval_plotter`` (evaluation_tools.py:19-136): 5×N figure of sample image,
  sample event frame, and per-axis predicted-vs-GT velocities for 1 train +
  N-1 val trajectories.
* ``visualize_images`` (evaluation_tools.py:138-267): per-frame 2×2 tiles of
  [event frame | pre-upsample depth; predicted depth + velocity arrow |
  GT depth + GT arrow], written as an animated gif.

The port's copy of ``evfly_tpu/train/evaluation_tools.py``: the model runs
through the Learner's ``run_model``; matplotlib, imageio and cv2 are
display-side only and imported where a plot or gif is made.
"""

from __future__ import annotations

import os
import time
from os.path import join as opj
from typing import Tuple

import numpy as np

from ..utils.ev_vis import simple_evim


def _title_for(learner, checkpoint_path) -> str:
    cp = checkpoint_path if not isinstance(checkpoint_path, list) else checkpoint_path[0]
    exp_name = os.path.basename(os.path.dirname(cp))
    model_ckpt = os.path.splitext(os.path.basename(cp))[0]
    return opj(exp_name, model_ckpt).replace("/", "__")


def eval_plotter(learner, checkpoint_path, load_ckpt: bool = True, dataSetstoTest: int = 5):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    title = _title_for(learner, checkpoint_path)
    if load_ckpt:
        learner.load_from_checkpoint(checkpoint_path)
    learner.mylogger(f"[EVAL_TOOLS] Evaluating {title}...")

    numtrajs = min(dataSetstoTest, learner.num_val_steps)
    num_trains = 1
    ims, evframes, preds, cmds, traj_names = [], [], [], [], []

    train_starts = learner.train.traj_starts
    val_starts = learner.val.traj_starts

    st_run = time.time()
    for it in range(numtrajs):
        if it < num_trains:
            out = learner.run_model(
                it, train_starts, learner.train.trajlength,
                np.arange(len(train_starts)), "train",
                return_inputs=True, do_step=False,
            )
            traj_names.append("train_" + os.path.basename(str(learner.train.dirs[it]).rstrip("/")))
        else:
            out = learner.run_model(
                it, val_starts, learner.val.trajlength,
                np.arange(len(val_starts)), "val",
                return_inputs=True, do_step=False,
            )
            traj_names.append("val_" + os.path.basename(str(learner.val.dirs[it]).rstrip("/")))
        _loss, (pred, _extras), (traj_ims, traj_evs, desvel, gt) = out
        pred_vel, _pred_vision = pred
        pred_vel = pred_vel * desvel[1:] if len(desvel) == len(pred_vel) + 1 else pred_vel * desvel[: len(pred_vel)]
        cmd = gt[0]

        # first non-free-space image for viewability (evaluation_tools.py:80-92)
        if traj_ims.mean() < 0.95:
            nb = np.where(np.mean(traj_ims, axis=(2, 3)) < 0.90)[0]
            first_idx = int(nb[0]) if len(nb) else 0
        else:
            first_idx = 0
        ims.append(traj_ims[first_idx, 0])
        preds.append(np.asarray(pred_vel))
        cmds.append(np.asarray(cmd))
        if traj_evs is not None:
            evframes.append(traj_evs[min(first_idx, len(traj_evs) - 1), 0])
        else:
            evframes.append(np.zeros_like(ims[-1]))

    learner.mylogger(f"[EVAL_TOOLS] Evaluated {numtrajs} trajectories in {time.time() - st_run:.2f} s")

    if learner.rescale_evs > 0.0:
        evframes = [e * learner.rescale_evs for e in evframes]

    fig, axs = plt.subplots(5, max(numtrajs, 2), figsize=(16, 8))
    for i in range(numtrajs):
        axs[0, i].imshow(ims[i])
        axs[0, i].set_title(traj_names[i])
        axs[1, i].imshow(evframes[i])
        for ax_i, dim in ((2, 0), (3, 1), (4, 2)):
            axs[ax_i, i].plot(preds[i][:, dim], label="pred", marker=".")
            axs[ax_i, i].plot(cmds[i][:, dim], label="gt")
            if dim > 0:
                lim = np.max(np.abs(cmds[i][:, dim])) + 0.5
                axs[ax_i, i].set_ylim([-lim, lim])
        if i == 0:
            for ax_i, lbl in ((0, "sample image"), (1, "sample evframe"), (2, "x vel"), (3, "y vel"), (4, "z vel")):
                axs[ax_i, i].set_ylabel(lbl)
            axs[2, i].legend()
    fig.suptitle(title)
    return fig, title


def visualize_images(learner, checkpoint_path, load_ckpt: bool = False, dataSetstoTest: int = 5):
    import imageio

    try:
        import cv2
    except ImportError:
        cv2 = None

    title = _title_for(learner, checkpoint_path)
    if load_ckpt:
        learner.load_from_checkpoint(checkpoint_path)
    learner.mylogger(f"[EVAL_TOOLS] Evaluating {title}...")

    num_evals, num_trains = 3, 1
    train_starts = learner.train.traj_starts
    val_starts = learner.val.traj_starts
    traj_output = []

    for it in range(num_evals):
        if it < num_trains:
            starts, tlen, mode = train_starts, learner.train.trajlength, "train"
            idx = it
        else:
            starts, tlen, mode = val_starts, learner.val.trajlength, "val"
            idx = it - num_trains
        _loss, (pred, _extras), (traj_ims, traj_evs, desvel, gt) = learner.run_model(
            idx, starts, tlen, np.arange(len(starts)), mode, return_inputs=True, do_step=False
        )
        if learner.rescale_evs > 0.0 and traj_evs is not None:
            traj_evs = traj_evs * learner.rescale_evs
        pred_vel, pred_vision = pred
        traj_output.append((traj_evs, pred_vision, pred_vel, gt, desvel))

    def _arrow(img, yvel, zvel):
        if cv2 is None:
            return img
        h, w = img.shape[:2]
        return cv2.arrowedLine(
            img, (w // 2, h // 2),
            (int(w // 2 - yvel * min(h, w)), int(h // 2 - zvel * min(h, w))),
            (0, 0, 255), 2,
        )

    paths = []
    for traj_i, (evs, pred_vision, pred_vel, gt, desvel) in enumerate(traj_output):
        if evs is None:
            continue
        h, w = evs.shape[2], evs.shape[3]
        frames = []
        for i in range(min(evs.shape[0], pred_vision.shape[0])):
            frame = np.zeros((2 * h, 2 * w, 3), np.uint8)
            evfr, _ = simple_evim(evs[i].squeeze(), style="redblue-on-white")
            frame[:h, :w] = evfr
            pred_im = np.clip(pred_vision[i].squeeze(), 0.0, 1.0)
            pred_rgb = (np.stack([pred_im] * 3, -1) * 255).astype(np.uint8)
            frame[:h, w:] = pred_rgb
            pred_arrow = _arrow(pred_rgb.copy(), pred_vel[i][1], pred_vel[i][2])
            frame[h:, :w] = pred_arrow
            gt_im = (np.stack([np.clip(gt[1][i].squeeze(), 0, 1)] * 3, -1) * 255).astype(np.uint8)
            # desvel rows can be (1,) arrays; float() on ndim>0 is a NumPy
            # deprecation headed for a hard error — flatten first
            dv = float(np.asarray(desvel[min(i, len(desvel) - 1)]).reshape(()))
            gt_arrow = _arrow(gt_im, gt[0][i][1] / dv, gt[0][i][2] / dv)
            frame[h:, w:] = gt_arrow
            frames.append(frame)
        mode = "train" if traj_i < num_trains else "val"
        out = opj(
            learner.workspace,
            f"{os.path.basename(learner.workspace)}__{title}_{mode}{traj_i if mode == 'train' else traj_i - num_trains}.gif",
        )
        imageio.mimsave(out, np.stack(frames))
        paths.append(out)
        learner.mylogger(f"[EVAL_TOOLS] {mode} traj output idx {traj_i} has {len(frames)} frames")
    return paths


def main():
    """CLI parity with ``python learner/evaluation_tools.py --config ...``
    (evaluation_tools.py:269-323)."""
    from ..configs import argparsing
    from .learner import Learner

    args = argparsing()
    learner = Learner(args)
    checkpoint_paths = args.checkpoint_path
    if not isinstance(checkpoint_paths, list):
        checkpoint_paths = [checkpoint_paths]

    import os
    import time

    if not learner.combine_checkpoints:
        for cp in checkpoint_paths:
            print(f"[EVAL_TOOLS] Evaluating {cp}...")
            st = time.time()
            fig, title = eval_plotter(learner, cp)
            fig.savefig(
                opj(learner.workspace, f"eval_{os.path.basename(learner.workspace)}__{title}.png")
            )
            learner.mylogger(f"[EVAL_TOOLS] eval_plotter finished {title} in {time.time() - st:.2f} s")
            visualize_images(learner, cp, load_ckpt=True)
    else:
        print(f"[EVAL_TOOLS] Evaluating combination checkpoints model from {checkpoint_paths}...")
        fig, title = eval_plotter(learner, checkpoint_paths, load_ckpt=False)
        fig.savefig(
            opj(learner.workspace, f"eval_{os.path.basename(learner.workspace)}__{title}.png")
        )
        visualize_images(learner, checkpoint_paths, load_ckpt=False)


if __name__ == "__main__":
    main()
