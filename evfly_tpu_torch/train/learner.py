"""The Learner: config -> workspace -> data -> model -> train and val loops.

Port of ``evfly_tpu/train/learner.py`` with its public API, attributes and
files (reference learner.py:36-1165): ``train_loop()``, ``validation(ep)``,
``run_model(...)``, ``save_model``, ``load_from_checkpoint``; the workspace
``d%m_%d_t%H_%M[_n]`` with ``args.txt``, ``config.txt``, ``log.txt`` and
``train_val_dirs.npy``; the checkpoints ``model_ep{ep:06d}.pth`` and
``model_best_``/``model_best{i}_`` with the old best deleted; the LR
schedule (linear warm-up, then constant or exponential decay) set per
trajectory and continued on resume; TensorBoard scalars when
``torch.utils.tensorboard`` imports, a logged line otherwise.

One execution path: the per-chunk loop, each chunk gathered from the split
held on the device (int8/uint8-quantized with ``device_data_quantized``,
else bf16; the host's f32 frames above ``DEVICE_DATA_MAX_BYTES``), padded
to a fixed size with a validity mask.  The JAX package's ``traj_scan``,
``epoch_scan`` and ``scan_group`` choose how that loop is dispatched on a
TPU and compute the same thing; they are accepted and change nothing here.
``dp_devices > 0`` trains by chunk-level data parallelism instead
(``_dp_train_epoch``, ``parallel/``): G = ``dp_devices`` x
``dp_chunks_per_device`` chunks per Adam step, on the device-resident
split.  ``dp_devices = 1`` is one process (G chunks in one forward on the
card); more needs a process group of that many processes, one per card
(``torchrun --nproc_per_node``), each writing its own workspace (rank r > 0
with the suffix ``_rank{r}``).

The Learner runs on the card unless the config says ``device = cpu`` or the
caller passes ``device="cpu"``.  Shuffling uses numpy's global RNG as the
JAX package does (``np.random.seed(seed)``, one permutation per epoch), so
both visit trajectories in the same order; dropout and augmentation draw
from one ``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

import glob
import math
import os
import time
from datetime import datetime
from os.path import join as opj
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import EvflyConfig, config_device
from ..data.dataloading import TrajectorySplit, concat_frames, dataloader
from ..device import DeviceLike, resolve_device
from ..models import port
from ..models.registry import build_model
from .stepfn import make_batch_slicer, make_eval_step, make_train_step


def _model_kind(model_type) -> str:
    if isinstance(model_type, list):
        if model_type[0] == "OrigUNet" and model_type[1] == "VITFLY_ViTLSTM":
            return "joint_vitlstm"
        if model_type[0] == "OrigUNet" and model_type[1] == "ConvNet_w_VelPred":
            return "joint_convnet"
        raise ValueError(model_type)
    if model_type == "OrigUNet":
        return "origunet"
    if "VITFLY_" in model_type or model_type in (
        "LSTMNetVIT", "ViT", "LSTMNet", "ConvNet", "UNetConvLSTMNet",
    ):
        return "vitfly"
    if model_type == "ConvNet_w_VelPred":
        return "convnet_velpred"
    return "other"


def dataloader_kwargs(c: EvflyConfig, train_val_dirs=None) -> dict:
    """The arguments the Learner passes ``dataloader`` for config ``c``
    (also ``cache_dataset``'s, whose cache the Learner's call then hits)."""
    return dict(
        val_split=c.val_split,
        short=c.short,
        seed=c.seed,
        train_val_dirs=train_val_dirs,
        events=c.events_filename,
        keep_collisions=c.keep_collisions,
        do_transform=c.do_transform,
        use_h5=c.use_h5,
        resize_input=c.resize_input,
        split_method=c.split_method,
        rescale_depth=c.rescale_depth,
        rescale_evs=c.rescale_evs,
        evs_min_cutoff=c.evs_min_cutoff,
    )


def _rank_suffix() -> str:
    """``_rank{r}`` for rank r > 0 of a process group, so that the ranks of
    a data-parallel run each write a workspace of their own."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_rank() > 0:
        return f"_rank{dist.get_rank()}"
    return ""


def _seed_of(c: EvflyConfig) -> int:
    return c.seed if (c.seed is not None and c.seed >= 0) else 0


class Learner:
    # cap for keeping a whole split resident on the device, the JAX
    # package's: one config gives the same numbers in both packages.  Above
    # it every chunk is copied from the host's f32 frames.
    DEVICE_DATA_MAX_BYTES = 10 * 1024**3

    def __init__(
        self,
        args: Optional[EvflyConfig] = None,
        dataset_name=None,
        short: int = 0,
        no_model: bool = False,
        val_split: float = 0.2,
        events: str = "",
        do_transform: bool = False,
        use_h5: bool = True,
        device: DeviceLike = None,
    ):
        if args is None:
            args = EvflyConfig(
                dataset=[dataset_name] if not isinstance(dataset_name, list) else dataset_name,
                short=short,
                val_split=val_split,
                events=events,
                do_transform=do_transform,
                use_h5=use_h5,
                seed=-2,
                keep_collisions=True,
                load_trainval=True,
                model_type=["LSTMNet"],
                basedir=".",
                datadir="data/datasets",
            )
        self.args = args
        self.cfg = args

        c = self.cfg
        if device is None and config_device(c.device) == "cpu":
            device = "cpu"
        self.device = resolve_device(device)
        self.model_type = c.model_type_norm
        self.checkpoint_path = c.checkpoint_path_norm
        self.combine_checkpoints = c.combine_checkpoints
        self.num_recurrent = c.num_recurrent
        self.batch_size = c.batch_size
        self.loss_weights = c.loss_weights
        self.optional_loss_param = c.optional_loss_param
        self.events = c.events_filename
        self.lr = c.lr
        self.N_eps = c.N_eps
        self.rescale_evs = c.rescale_evs

        dataset_name_list = c.dataset if isinstance(c.dataset, list) else [c.dataset]
        self.dataset_name = dataset_name_list

        # combine_checkpoints set without a checkpoint list means nothing
        if self.combine_checkpoints and not isinstance(self.checkpoint_path, list):
            self.combine_checkpoints = False

        if c.seed is not None and c.seed >= 0:
            np.random.seed(c.seed)

        # ---------------- workspace ----------------
        expname = datetime.now().strftime("d%m_%d_t%H_%M")
        base_ws = opj(c.basedir, c.logdir, expname) + c.ws_suffix + _rank_suffix()
        ws = base_ws
        ctr = 2
        while os.path.exists(ws):
            ws = base_ws + f"_{ctr}"
            ctr += 1
        self.workspace = ws
        os.makedirs(self.workspace)
        self.previous_tag = None
        self.logfile = open(opj(self.workspace, "log.txt"), "w")

        with open(opj(self.workspace, "args.txt"), "w") as fh:
            for k in sorted(c.to_dict()):
                fh.write(f"{k} = {getattr(c, k)}\n")
        if c.config and os.path.exists(str(c.config)):
            with open(opj(self.workspace, "config.txt"), "w") as fh, open(c.config) as src:
                fh.write(src.read())

        self.writer = None
        if not no_model:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(self.workspace)
            except Exception:
                self.mylogger("[Learner init] TensorBoard unavailable; scalars to log.txt only")

        self.mylogger(f"[Learner init] Making workspace {self.workspace}")

        if self.dataset_name in (None, [None], [""], ["None"]):
            self.dataset_name = [None]
            self.mylogger("[Learner init] No dataset name provided, not loading a dataset!")

        self.dataset_dir = []
        for dn in self.dataset_name:
            if dn is None:
                continue
            self.dataset_dir.append(dn if os.path.isabs(dn) else opj(c.datadir, dn))

        # ---------------- dataloading ----------------
        train_val_dirs = None
        if self.checkpoint_path not in ("", [""], None) and c.load_trainval:
            self.mylogger("[Learner init] Trying to load train_val_dirs from checkpoint...")
            try:
                cp = self.checkpoint_path if isinstance(self.checkpoint_path, str) else self.checkpoint_path[0]
                train_val_dirs = tuple(
                    np.load(opj(os.path.dirname(cp), "train_val_dirs.npy"), allow_pickle=True)
                )
                self.mylogger("[Learner init] Loaded train_val_dirs from checkpoint")
            except Exception:
                self.mylogger("[Learner init] Could not load train_val_dirs from checkpoint, dataloading from scratch")

        self.train: Optional[TrajectorySplit] = None
        self.val: Optional[TrajectorySplit] = None
        if self.dataset_dir:
            self.learner_dataloading(train_val_dirs)
            self.num_training_steps = len(self.train.trajlength)
            self.num_val_steps = len(self.val.trajlength)
        else:
            self.num_training_steps = 0
            self.num_val_steps = 0

        self.lowest_val_loss = math.inf
        self.lr_warmup_iters = c.lr_warmup_epochs * max(self.num_training_steps, 1)

        # ---------------- model + optimizer ----------------
        self.model = None
        self.num_eps_trained = 0
        if not no_model:
            self.model = build_model(c, device=self.device,
                                     generator=torch.Generator().manual_seed(_seed_of(c)))
            self.mylogger(
                f"[SETUP] Number of parameters: "
                f"{sum(int(v.numel()) for v in self.model.state_dict().values()):,}"
            )
            self._build_optimizer()
            self.load_from_checkpoint(self.checkpoint_path)
            self._step_cache: Dict[Any, Any] = {}
            self._device_data: Dict[Any, Any] = {}
            # dropout and augmentation draws, on the device of the model
            self._generator = torch.Generator(device=self.device).manual_seed(_seed_of(c))

        self.total_its = self.num_eps_trained * self.num_training_steps
        self.last_eval_plot_ep = 0

    # ------------------------------------------------------------------ utils

    def mylogger(self, msg: str):
        tag = msg.split("[")[1].split("]")[0] if "[" in msg and "]" in msg else None
        if tag is not None and tag != self.previous_tag:
            print()
            self.logfile.write("\n")
        print(msg)
        self.logfile.write(msg + "\n")
        self.logfile.flush()
        self.previous_tag = tag

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict: its parameters and buffers by their
        reference keys, on the Learner's device."""
        return dict(self.model.state_dict())

    @params.setter
    def params(self, params) -> None:
        self.model.load_state_dict(params, strict=True)

    def _build_optimizer(self):
        """Adam over every parameter: the trainable keys of the JAX
        package's ``optax.masked(optax.adam)`` (buffers are not trained)."""
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def lr_scheduler(self, it: int) -> float:
        """learner.py:622-630 parity."""
        if it < self.lr_warmup_iters:
            return (0.9 * self.lr) / self.lr_warmup_iters * it + 0.1 * self.lr
        if self.cfg.lr_decay:
            return self.lr * (
                0.1 ** ((it - self.lr_warmup_iters) / (self.N_eps * max(self.num_training_steps, 1)))
            )
        return self.lr

    # ------------------------------------------------------------- dataload

    def learner_dataloading(self, train_val_dirs=None):
        c = self.cfg
        trains, vals = [], []
        for data_dir in self.dataset_dir:
            full = data_dir if os.path.isabs(data_dir) else opj(c.basedir, data_dir)
            self.mylogger(f"[DATALOADER] Loading from {data_dir} from set {self.dataset_dir}")
            tr, va, _is_png = dataloader(full, logger=self.mylogger,
                                         **dataloader_kwargs(c, train_val_dirs))
            trains.append(tr)
            vals.append(va)
            self.mylogger(
                f"[DATALOADER] Dataloading done | train images {tr.ims.shape}, val images {va.ims.shape}"
            )

        def concat(splits: List[TrajectorySplit]) -> TrajectorySplit:
            # frames stay lazy over the per-dataset mmaps above the
            # concat_frames threshold, never one f32 copy of a large mix
            return TrajectorySplit(
                meta=np.concatenate([s.meta for s in splits]),
                ims=concat_frames([s.ims for s in splits]),
                depths=concat_frames([s.depths for s in splits]),
                trajlength=np.concatenate([s.trajlength for s in splits]),
                desvel=np.concatenate([s.desvel for s in splits]),
                evs=(
                    [ev for s in splits for ev in s.evs] if splits[0].evs is not None else None
                ),
                dirs=[d for s in splits for d in s.dirs],
                dirs_ids=[i for s in splits for i in s.dirs_ids],
            )

        self.train = concat(trains)
        self.val = concat(vals)

        np.save(
            opj(self.workspace, "train_val_dirs.npy"),
            np.array(
                (self.train.dirs, self.val.dirs, self.train.dirs_ids, self.val.dirs_ids),
                dtype=object,
            ),
        )

    # ------------------------------------------------------------ checkpoint

    def save_model(self, ep: int, best: int = -2):
        ep_str = str(ep).zfill(6)
        if best == -2:
            self.mylogger(f"[SAVE] Saving model at epoch {ep}")
            model_path = opj(self.workspace, f"model_ep{ep_str}.pth")
            port.save_state_dict(self.params, model_path)
            self.mylogger(f"[SAVE] Model saved at {self.workspace}")
        else:
            suffix = "_best_" if best < 0 else f"_best{best}_"
            self.mylogger(f"[SAVE] Saving best (type {best}) model at epoch {ep}")
            model_path = opj(self.workspace, f"model{suffix}ep{ep_str}.pth")
            for f in glob.glob(opj(self.workspace, f"model{suffix}*")):
                os.remove(f)
            port.save_state_dict(self.params, model_path)
            self.mylogger(f"[SAVE] Best model saved at {model_path}")

    def load_from_checkpoint(self, checkpoint_path):
        if checkpoint_path in ("", [""], None, [None], [], ["None"]):
            print("[SETUP] In load_from_checkpoint, but checkpoint_path is empty, so not loading from checkpoint")
            return
        cp0 = checkpoint_path if isinstance(checkpoint_path, str) else checkpoint_path[0]
        self.num_eps_trained = port.parse_epoch_from_path(cp0)
        if self.num_eps_trained == 0:
            self.mylogger(
                f"[SETUP] Could not parse number of epochs trained from checkpoint path {checkpoint_path}, using 0"
            )
        self.mylogger(
            f"[SETUP] Loading checkpoint from {checkpoint_path}, already trained for {self.num_eps_trained} epochs"
        )
        params = self.params
        if self.combine_checkpoints and isinstance(checkpoint_path, list):
            sds = [port.load_state_dict(cp) for cp in checkpoint_path]
            # the reference names VITFLY_ViTLSTM's attribute 'vitfly_vitlstm'
            names = [self.model_type[0].lower(), self.model_type[1].lower()]
            combined = port.combine_state_dicts(sds, model_names=names)
            params = port.load_into(params, combined, strict=False)
        elif isinstance(self.model_type, list):
            cps = checkpoint_path if isinstance(checkpoint_path, list) else [checkpoint_path]
            if len(cps) == 1:
                # a composite resumed from its own snapshot: save_model writes
                # the whole prefixed state_dict
                params = port.load_into(params, port.load_state_dict(cps[0]), strict=False)
            else:
                sd0 = port.load_state_dict(cps[0])
                sd1 = port.load_state_dict(cps[1])
                params = port.load_into(params, sd0, prefix="origunet.")
                second = "vitfly_vitlstm." if self.model_type[1] == "VITFLY_ViTLSTM" else "convnet_w_velpred."
                params = port.load_into(params, sd1, prefix=second)
        else:
            params = port.load_into(params, port.load_state_dict(checkpoint_path), strict=False)
        self.params = params

    # ------------------------------------------------------------ the steps

    def _kind(self) -> str:
        return _model_kind(self.model_type)

    def _get_device_data(self, mode: str, B: int):
        """The split's arrays on the device, padded by B zero frames, and the
        per-trajectory offsets of its event frames; None above
        ``DEVICE_DATA_MAX_BYTES``.

        Frames live int8 (events in [-1, 1], steps of 1/127) and uint8
        (depths in [0, 1], steps of 1/255) with ``device_data_quantized``,
        error <= 1/254 per value, else bf16 (round to nearest even); the
        batch slicer decodes them.  The staging copies are built block by
        block in the residency dtype, never the whole split as f32.  One
        entry per mode: a larger B rebuilds it.
        """
        cached = self._device_data.get(mode)
        if cached is not None and cached[0] >= B:
            return cached[1]
        if cached is not None:
            self._device_data.pop(mode)
        split = self.train if mode == "train" else self.val
        H, W = split.ims.shape[-2], split.ims.shape[-1]
        frame_b = 1 if self.cfg.device_data_quantized else 2
        n_ev = sum(ev.shape[0] for ev in split.evs) if split.evs is not None else 0
        nbytes = (
            split.depths.size * frame_b
            + n_ev * H * W * frame_b
            + split.desvel.nbytes
            + split.velcmd.nbytes
        )
        if nbytes > self.DEVICE_DATA_MAX_BYTES:
            self._device_data[mode] = (B, None)
            return None
        if self.cfg.device_data_quantized:
            d_dtype, e_dtype = torch.uint8, torch.int8
            d_tf = lambda b: torch.from_numpy(np.clip(np.round(b * 255.0), 0, 255).astype(np.uint8))
            e_tf = lambda b: torch.from_numpy(np.clip(np.round(b * 127.0), -127, 127).astype(np.int8))
        else:
            d_dtype = e_dtype = torch.bfloat16
            d_tf = e_tf = lambda b: torch.from_numpy(np.asarray(b, np.float32)).to(torch.bfloat16)

        def _blocks(arr, rows=512):
            if hasattr(arr, "iter_blocks"):  # ConcatFrames
                yield from arr.iter_blocks(rows)
            else:
                for i in range(0, arr.shape[0], rows):
                    yield i, np.asarray(arr[i : i + rows])

        N = split.depths.shape[0]
        depths_h = torch.zeros((N + B, H, W), dtype=d_dtype)  # B pad rows stay zero
        for off, blk in _blocks(split.depths):
            depths_h[off : off + blk.shape[0]] = d_tf(blk)
        if split.evs is not None:
            ev_lens = np.array([ev.shape[0] for ev in split.evs])
            ev_offsets = np.cumsum(ev_lens) - ev_lens
            n_ev_total = int(ev_lens.sum()) if len(ev_lens) else 0
            evs_h = torch.zeros((n_ev_total + B, H, W), dtype=e_dtype)
            for ev, off0 in zip(split.evs, ev_offsets):
                for off, blk in _blocks(ev):
                    evs_h[off0 + off : off0 + off + blk.shape[0]] = e_tf(blk)
        else:
            ev_offsets = np.zeros(len(split.trajlength), np.int64)
            evs_h = torch.zeros((B, H, W), dtype=e_dtype)  # placeholder, unused
        dev = {
            "depths": depths_h.to(self.device),
            "evs": evs_h.to(self.device),
            "desvel": torch.from_numpy(
                np.concatenate([np.asarray(split.desvel, np.float32), np.ones(B, np.float32)])
            ).to(self.device),
            "velcmd": torch.from_numpy(
                np.concatenate([np.asarray(split.velcmd, np.float32), np.zeros((B, 3), np.float32)])
            ).to(self.device),
        }
        del depths_h, evs_h
        out = (dev, ev_offsets)
        self._device_data[mode] = (B, out)
        return out

    def _get_step(self, mode: str, indexed: bool = False, B: int = 0):
        key = (mode, indexed, B)
        if key in self._step_cache:
            return self._step_cache[key]
        batch_fn = (
            make_batch_slicer(B, self.cfg.num_in_channels, self.cfg.num_out_channels)
            if indexed
            else None
        )
        if mode == "train":
            step = make_train_step(
                self.model, self._kind(), self.optimizer,
                self.loss_weights, self.optional_loss_param,
                data_augmentation=self.cfg.data_augmentation != 0.0,
                num_out_channels=self.cfg.num_out_channels,
                batch_fn=batch_fn,
                input_frame_scale=self.cfg.input_frame_scale,
            )
        else:
            step = make_eval_step(
                self.model, self._kind(), self.loss_weights, self.optional_loss_param,
                num_out_channels=self.cfg.num_out_channels,
                batch_fn=batch_fn,
                input_frame_scale=self.cfg.input_frame_scale,
            )
        self._step_cache[key] = step
        return step

    # -------------------------------------------------------------- run_model

    def _chunk_padded(self, arr: np.ndarray, ids: np.ndarray, B: int) -> np.ndarray:
        out = arr[ids]
        if len(ids) < B:
            pad_shape = (B - len(ids),) + out.shape[1:]
            out = np.concatenate([out, np.zeros(pad_shape, out.dtype)])
        return out

    def _host_batch(self, split, it, traj_starts, traj_ids, batch_ids, local, B_max):
        """One chunk from the host's f32 arrays, padded to B_max (the path
        above ``DEVICE_DATA_MAX_BYTES``)."""
        c = self.cfg
        n_valid = len(batch_ids)
        if c.num_in_channels == 2:
            inp = self._chunk_padded(split.evs[traj_ids[it]], local, B_max)[:, None]
        else:
            inp = self._chunk_padded(split.depths, batch_ids, B_max)[:, None]
        if c.num_out_channels == 2:
            gt_frames_h = self._chunk_padded(split.evs[traj_ids[it]], local, B_max)[:, None]
        else:
            gt_frames_h = self._chunk_padded(split.depths, batch_ids, B_max)[:, None]
        desvel = self._chunk_padded(np.asarray(split.desvel), batch_ids, B_max)[:, None].copy()
        # guard padded desvel against a division by zero in gt normalization
        desvel[n_valid:] = 1.0
        gt_vel_h = self._chunk_padded(np.asarray(split.velcmd), batch_ids, B_max)
        mask = np.zeros((B_max,), np.float32)
        mask[:n_valid] = 1.0
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        return {"input": to(inp), "desvel": to(desvel), "gt_vel": to(gt_vel_h),
                "gt_frames": to(gt_frames_h), "mask": to(mask)}

    def run_model(
        self,
        it: int,
        traj_starts: np.ndarray,
        traj_lengths: np.ndarray,
        traj_ids: np.ndarray,
        mode: str,
        return_inputs: bool = False,
        batch_size: int = 0,
        do_step: bool = True,
    ):
        """Run one trajectory through the model in padded chunks.

        Mirrors learner.py:920-1165: returns ((loss, loss_terms),
        (preds_full, extras)) and, with ``return_inputs``, the inputs for
        eval plotting.  In training with ``do_step`` each chunk is one train
        step; otherwise an eval step whose predictions fill preds_full.
        """
        split = self.train if mode == "train" else self.val
        c = self.cfg
        if c.num_in_channels not in (1, 2):
            raise ValueError(f"num_in_channels {c.num_in_channels}")

        T = int(traj_lengths[it]) - 1
        ids = np.arange(traj_starts[it] + 1, traj_starts[it] + traj_lengths[it])
        B = batch_size if batch_size > 0 else len(ids)
        # every chunk padded to one size; a larger ad-hoc batch_size still
        # gets a valid padding target
        B_max = max(B, self._chunk_B(mode)) if batch_size > 0 else self._max_tlen(mode)
        chunk_sets = [ids[i : i + B] for i in range(0, len(ids), B)]

        preds_vel_full = np.zeros((T, 3), np.float32)
        preds_vision_full = np.zeros((T, 1, split.ims.shape[-2], split.ims.shape[-1]), np.float32)
        gts_full = (
            np.zeros_like(preds_vel_full),
            np.zeros_like(preds_vision_full),
        )

        training = mode == "train" and do_step
        dd = self._get_device_data(mode, B_max)
        use_indexed = dd is not None
        step = self._get_step("train" if training else "eval", indexed=use_indexed, B=B_max)
        if use_indexed:
            device_data, ev_offsets = dd

        losses, values_list, gradnorm = [], [], None
        for batch_ids in chunk_sets:
            n_valid = len(batch_ids)
            local = batch_ids - 1 - traj_starts[it]
            if use_indexed:
                idx = {"start": int(batch_ids[0]),
                       "ev_start": int(ev_offsets[traj_ids[it]] + local[0]),
                       "n_valid": n_valid}
                args = (device_data, idx)
            else:
                args = (self._host_batch(split, it, traj_starts, traj_ids, batch_ids, local,
                                         B_max),)
            if training:
                batch_loss, values, gradnorm = step(*args, self._generator)
            else:
                batch_loss, values, pred_vel, pred_vision = step(*args)
                sl = slice(int(local[0]), int(local[0]) + n_valid)
                preds_vel_full[sl] = pred_vel[:n_valid].cpu().numpy()
                if pred_vision is not None:
                    preds_vision_full[sl] = pred_vision[:n_valid].cpu().numpy()
                gts_full[0][sl] = split.velcmd[batch_ids]
                if c.num_out_channels == 2:
                    gts_full[1][sl] = split.evs[traj_ids[it]][local][:, None]
                else:
                    gts_full[1][sl] = split.depths[batch_ids][:, None]
            losses.append(batch_loss)
            values_list.append(values)

        # one copy to the host per trajectory; sums in chunk order in f64,
        # as the JAX package's per-chunk float() sums
        total_loss = 0.0
        for v in torch.stack(losses).cpu().numpy().astype(np.float64):
            total_loss += float(v)
        term_values = None
        for v in torch.stack(values_list).cpu().numpy():
            term_values = v if term_values is None else term_values + v
        if training:
            self._last_gradnorm = float(gradnorm)  # the last chunk's, as JAX

        assert not math.isnan(total_loss), f"[RUN_MODEL] Loss is NaN at iteration {it}"

        preds_full = (preds_vel_full, preds_vision_full)
        extras = ()
        if not return_inputs:
            return (total_loss, term_values), (preds_full, extras)
        traj_input_ims = split.ims[ids][:, None]
        traj_input_evs = (
            split.evs[traj_ids[it]][:, None] if split.evs is not None else None
        )
        traj_desvels = split.desvel[ids][:, None]
        return (
            (total_loss, term_values),
            (preds_full, extras),
            (traj_input_ims, traj_input_evs, traj_desvels, gts_full),
        )

    def _chunk_B(self, mode: str) -> int:
        return self.batch_size if self.batch_size > 0 else self._max_tlen(mode)

    def _max_tlen(self, mode: str) -> int:
        split = self.train if mode == "train" else self.val
        return int(max(split.trajlength)) if len(split.trajlength) else 1

    # ------------------------------------------------------- DP train epoch

    def _get_dp_step(self, B: int):
        from ..parallel.data_parallel import make_dp_chunked_train_step
        from ..parallel.mesh import make_mesh

        key = ("dp", B)
        if key in self._step_cache:
            return self._step_cache[key]
        if getattr(self, "_dp_mesh", None) is None:
            self._dp_mesh = make_mesh(self.cfg.dp_devices, self.device)
        step = make_dp_chunked_train_step(
            self.model, self._kind(), self.optimizer, self._dp_mesh, B,
            num_in_channels=self.cfg.num_in_channels,
            num_out_channels=self.cfg.num_out_channels,
            loss_weights=self.loss_weights,
            optional_loss_param=self.optional_loss_param,
            data_augmentation=self.cfg.data_augmentation != 0.0,
            input_frame_scale=self.cfg.input_frame_scale,
        )
        self._step_cache[key] = step
        return step

    def _dp_train_epoch(self, shuffled, traj_starts, traj_lengths, B: int):
        """One epoch of chunk-level data-parallel training, as the JAX
        Learner's (``evfly_tpu/train/learner.py:851-933``; the reference
        trains on one GPU) -> (ep_loss, ep_terms, gradnorm): the mean over
        trajectories of their chunk-loss sums, as the sequential path's.

        The epoch's chunks in the shuffled trajectory order, padded to a
        multiple of G with n_valid 0 copies of chunk 0; one Adam step per G
        chunks on their gradient averaged over the real chunks, where the
        reference steps per chunk (``tools/dp_quality`` measures what that
        does to training).  The LR schedule counts trajectories, so a
        fractional counter ``it_float`` advances n_real x
        (num_training_steps / n_chunks) per step: warm-up and decay land at
        the sequential path's epoch fractions; int(it_float) sets each
        step's LR.  The step's sums stay on the device until the epoch
        ends (n_real is known on the host)."""
        from ..parallel.mesh import replicate_params

        c = self.cfg
        dd = self._get_device_data("train", B)
        if dd is None:
            raise RuntimeError(
                "data-parallel training needs the split resident on the device; this one is "
                f"above DEVICE_DATA_MAX_BYTES ({self.DEVICE_DATA_MAX_BYTES} bytes)")
        device_data, ev_offsets = dd
        step = self._get_dp_step(B)
        mesh = self._dp_mesh
        replicate_params(self.model, mesh)
        replicate_params(self.optimizer, mesh)

        starts, ev_starts, n_valids = [], [], []
        for it in range(self.num_training_steps):
            ids = np.arange(traj_starts[it] + 1, traj_starts[it] + traj_lengths[it])
            for i in range(0, len(ids), B):
                chunk = ids[i : i + B]
                starts.append(int(chunk[0]))
                ev_starts.append(int(ev_offsets[shuffled[it]] + (chunk[0] - 1 - traj_starts[it])))
                n_valids.append(len(chunk))
        n_chunks = len(starts)
        G = max(c.dp_devices, 1) * max(c.dp_chunks_per_device, 1)
        pad = (-n_chunks) % G
        starts += [starts[0]] * pad
        ev_starts += [ev_starts[0]] * pad
        n_valids += [0] * pad
        # every rank takes rank 0's chunk order (its shuffle)
        order = mesh.broadcast_(torch.tensor([starts, ev_starts, n_valids], dtype=torch.int64,
                                             device=mesh.device)).cpu().numpy()

        losses, values, gradnorms = [], [], []
        n_steps = len(starts) // G
        it_scale = self.num_training_steps / max(n_chunks, 1)
        it_float = float(self.total_its)
        for s in range(n_steps):
            sl = slice(s * G, (s + 1) * G)
            new_lr = self.lr_scheduler(int(it_float))
            for group in self.optimizer.param_groups:
                group["lr"] = new_lr
            idxs = {"start": order[0, sl], "ev_start": order[1, sl], "n_valid": order[2, sl]}
            loss_sum, values_sum, gn, _ = step(device_data, idxs, self._generator)
            losses.append(loss_sum)
            values.append(values_sum)
            gradnorms.append(gn)
            it_float += max(int((order[2, sl] > 0).sum()), 1) * it_scale
        self._last_lr = self.lr_scheduler(int(it_float))
        ep_loss_sum = 0.0
        for v in torch.stack(losses).cpu().numpy().astype(np.float64):
            ep_loss_sum += float(v)
        ep_values_sum = None
        for v in torch.stack(values).cpu().numpy():
            ep_values_sum = v if ep_values_sum is None else ep_values_sum + v
        gradnorm = float(sum(float(g) for g in torch.stack(gradnorms).cpu().numpy()))
        assert not math.isnan(ep_loss_sum), "[DP] Loss is NaN"
        return (
            ep_loss_sum / self.num_training_steps,
            ep_values_sum / self.num_training_steps,
            gradnorm / max(n_steps, 1),
        )

    # ------------------------------------------------------------ train loop

    def train_loop(self):
        """Reference ``Learner.train`` (learner.py:670-749); with
        ``dp_devices > 0`` each epoch is ``_dp_train_epoch``."""
        c = self.cfg
        self.mylogger(f"[TRAIN] Training for {self.N_eps} epochs")
        train_start = time.time()
        traj_starts_base = self.train.traj_starts

        new_lr = self.lr
        ep = self.num_eps_trained
        for ep in range(self.num_eps_trained, self.num_eps_trained + self.N_eps):
            if c.eval_tools_freq > 0 and (ep - self.num_eps_trained) % c.eval_tools_freq == 0:
                self.eval_tools(ep)
            if (ep - self.num_eps_trained) % c.save_model_freq == 0:
                self.save_model(ep, best=-2)
            if (ep - self.num_eps_trained) % c.val_freq == 0:
                self.validation(ep)

            ep_loss = 0.0
            ep_loss_terms = []
            gradnorm = 0.0

            shuffled = np.random.permutation(len(traj_starts_base))
            traj_starts = traj_starts_base[shuffled]
            traj_lengths = self.train.trajlength[shuffled]

            if c.dp_devices > 0:
                ep_loss, ep_loss_terms, gradnorm = self._dp_train_epoch(
                    shuffled, traj_starts, traj_lengths, B=self._chunk_B("train"))
                self.total_its += self.num_training_steps
                new_lr = self._last_lr
            else:
                for it in range(self.num_training_steps):
                    # total_its starts from the checkpoint's epoch, so a resumed
                    # run continues the warm-up and decay (learner.py:718-720)
                    new_lr = self.lr_scheduler(self.total_its)
                    for group in self.optimizer.param_groups:
                        group["lr"] = new_lr
                    (loss, loss_terms), _ = self.run_model(
                        it, traj_starts, traj_lengths, shuffled, "train",
                        batch_size=self.batch_size,
                    )
                    gradnorm += getattr(self, "_last_gradnorm", 0.0)
                    ep_loss += loss
                    ep_loss_terms.append(loss_terms)
                    self.total_its += 1
                self._last_lr = new_lr

                ep_loss /= self.num_training_steps
                gradnorm /= self.num_training_steps
                ep_loss_terms = np.mean(ep_loss_terms, axis=0)

            if ep % c.print_trainprogress_freq == 0:
                terms = ", ".join(f"{t:.3f}" for t in ep_loss_terms)
                self.mylogger(
                    f"[TRAIN] Completed epoch {ep + 1}/{self.num_eps_trained + self.N_eps}, "
                    f"ep_loss = {ep_loss:.3f}, terms = {terms}, "
                    f"time = {time.time() - train_start:.2f}s"
                )
            if self.writer:
                self.writer.add_scalar("train/loss", ep_loss, ep)
                self.writer.add_scalar("train/gradnorm", gradnorm, ep)
                self.writer.add_scalar("train/lr", new_lr, ep)
                for i, t in enumerate(ep_loss_terms):
                    self.writer.add_scalar(f"train/loss_term_{i}", t, ep)
                self.writer.flush()

        self.mylogger(f"[TRAIN] Training complete, total time = {time.time() - train_start:.2f}s")
        self.save_model(ep, best=-2)

        if c.eval_tools_on_best:
            best_eps = []
            for f in glob.glob(opj(self.workspace, "model_best*.pth")):
                best_eps.append(int(f.split("_")[-1][2:-4]))
            for b_ep in sorted(best_eps):
                self.eval_tools(b_ep, load_ckpt=True)

    def validation(self, ep: int):
        """Reference ``Learner.validation`` (learner.py:751-801)."""
        c = self.cfg
        val_start = time.time()
        ep_loss = 0.0
        ep_loss_terms = []
        val_traj_starts = self.val.traj_starts
        for it in range(self.num_val_steps):
            (loss, loss_terms), _ = self.run_model(
                it, val_traj_starts, self.val.trajlength, np.arange(len(val_traj_starts)), "val",
                batch_size=self.batch_size,
            )
            ep_loss += loss
            ep_loss_terms.append(loss_terms)
        ep_loss /= max(self.num_val_steps, 1)
        ep_loss_terms = np.mean(ep_loss_terms, axis=0) if ep_loss_terms else np.zeros(2)

        # first-call initialization keyed off state, not the epoch number, so
        # an out-of-sequence validation never resets the best tracking
        if not isinstance(self.lowest_val_loss, list) or len(self.lowest_val_loss) != len(ep_loss_terms) + 1:
            self.lowest_val_loss = [math.inf] * (len(ep_loss_terms) + 1)

        if ep % c.print_trainprogress_freq == 0:
            terms = ", ".join(f"{t:.3f}" for t in ep_loss_terms)
            self.mylogger(
                f"[VAL] Validated epoch {ep + 1}/{self.num_eps_trained + self.N_eps} over "
                f"{self.val.ims.shape[0]} images, val_loss = {ep_loss:.6f}, terms = {terms}, "
                f"time taken = {time.time() - val_start:.2f} s"
            )
        if self.writer:
            self.writer.add_scalar("val/loss", ep_loss, ep)
        for i, t in enumerate(ep_loss_terms):
            if self.writer:
                self.writer.add_scalar(f"val/loss_term_{i}", t, ep)
            if t < self.lowest_val_loss[i + 1]:
                self.lowest_val_loss[i + 1] = t
                self.mylogger(
                    f"[VAL] New lowest val_loss term {i} = {t:.6f} at ep "
                    f"{ep + 1}/{self.num_eps_trained + self.N_eps}, saving model"
                )
                self.save_model(ep, best=i)
        if self.writer:
            self.writer.flush()
        if ep_loss < self.lowest_val_loss[0]:
            self.lowest_val_loss[0] = ep_loss
            self.mylogger(
                f"[VAL] New lowest val_loss = {ep_loss:.6f} at ep "
                f"{ep + 1}/{self.num_eps_trained + self.N_eps}, saving model"
            )
            self.save_model(ep, best=-1)

    def eval_tools(self, ep: int, load_ckpt: bool = False):
        """Periodic eval plot generation (learner.py:652-668)."""
        self.last_eval_plot_ep = ep
        try:
            import matplotlib  # noqa: F401

            from .evaluation_tools import eval_plotter
        except ImportError as e:  # matplotlib may be unavailable headless
            self.mylogger(f"[SAVE] eval_tools unavailable: {e}")
            return
        model_path = opj(self.workspace, f"model_ep{str(ep).zfill(6)}.pth")
        if not os.path.exists(model_path):
            cands = glob.glob(opj(self.workspace, f"model*{str(ep).zfill(6)}.pth"))
            if not cands:
                self.mylogger(f"[SAVE] Model checkpoint not found for ep {ep}, skipping eval plot")
                return
            model_path = cands[0]
        fig, title = eval_plotter(self, model_path, load_ckpt=load_ckpt)
        if self.writer:
            self.writer.add_figure("val/plot", fig, global_step=ep)
            self.writer.flush()
        import matplotlib.pyplot as plt

        plt.close(fig)
