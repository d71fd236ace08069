"""Training orchestrator (run_train.py parity), on one device or across
several.

Counterpart of hover_net_tpu/train/manager.py. Per phase
(TrainConfig.phases): build the model and optimizer, load pretrained
weights (a trainer or reference `.tar`, a JAX `.msgpack`, an ImageNet
`.npz`, or chain from the previous phase's last epoch), wire the
train/valid engines and callbacks, run the epoch loop with the PyTorch
train step. Checkpoints are the reference's `.tar` ({'desc',
'optimizer', 'step'}), and `--resume` continues a phase from its last
saved epoch (the reference left resume as a TODO, run_train.py:176).
A phase the JAX trainer began resumes too: its last checkpoint is then
its `net_epoch=N.msgpack`, with the optax Adam state in `<path>.opt`,
and the phase goes on writing the port's `.tar`.

The trainer runs on `device` ('cuda' by default; 'cpu' only when asked —
a missing GPU raises, there is no fallback). As the JAX trainer takes
every device of its mesh, `n_devices=None` takes every CUDA card from
`device` on (`train_devices`). On one device the phases run in this
process. On several, `run` starts one process a device
(parallel/distributed.py) and each runs the phases on its shard of every
global batch of `batch_size[mode] * n_devices`, with the data-parallel
train step; rank 0 broadcasts its starting state, and alone runs
validation (over the whole valid set, on its device), the logging,
stats.json and the checkpoints, while the other ranks wait at a barrier
at the end of each epoch. After each phase the ranks check that they
hold the same parameters and buffers, bit for bit.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.train_pipeline import PatchDataset, PrefetchLoader, TrainLoader
from ..models import checkpoints as ckpt
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..parallel import distributed
from ..parallel.mesh import canonical_device, resolve_device
from ..parallel.train_parallel import (
    init_train_state, make_eval_step, make_optimizer,
    make_train_step,
)
from . import callbacks as cb
from .engine import Events, RunEngine
from .validation import proc_valid_step_output, viz_train_step_output


class RunInfo:
    """Everything the callbacks need to reach the training objects, and
    the phase's per-step record: `losses` (each step's overall_loss),
    `step_s` (each train step's host seconds, ending when its loss
    scalars reach the host) and `wait_s` (the wait for each batch, from
    the prefetch loader); and `run_s`, the host seconds of the phase's
    whole run (its epochs with their validation, callbacks, checkpoints
    and the workers' start)."""

    def __init__(self, model, tx, lr_schedule, train_state):
        self.model = model
        self.tx = tx
        self.lr_schedule = lr_schedule
        self.train_state = train_state
        self.last_grad_norm = None
        self.losses: List[float] = []
        self.step_s: List[float] = []
        self.wait_s: List[float] = []
        self.run_s = 0.0

    def save_checkpoint(self, path):
        ckpt.save_train_tar(path, self.train_state.model,
                            self.train_state.optimizer,
                            self.train_state.step)


def train_devices(n_devices: Optional[int] = None, device="cuda",
                  devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a training run, one rank each. `devices`, when given,
    is taken as it is (its first `n_devices`; it may repeat a device).
    Else on CUDA: `n_devices` cards from `device` (cuda:0 by default) on,
    all of them when `n_devices` is None, as the JAX trainer's
    `make_mesh(None)` takes every device; asking for more cards than
    there are raises, as `make_mesh` asserts. On the CPU: `n_devices`
    ranks (1 when None) on the one CPU device."""
    if devices is None:
        dev = canonical_device(resolve_device(device))
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in
                       range(dev.index, torch.cuda.device_count())]
        else:
            devices = [dev] * (n_devices or 1)
    devices = [canonical_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}: {[str(d) for d in devices]}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("training needs at least one device")
    return devices


def _train_rank(ctx, config: TrainConfig, devices, resume: bool):
    """A rank of a multi-device run: the phases on this rank's shard;
    rank 0 returns the RunInfos."""
    mgr = TrainManager(config, devices=devices)
    mgr.ctx = ctx
    mgr.device = ctx.device
    infos = mgr.run(resume=resume)
    return infos if ctx.rank == 0 else None


class TrainManager:
    def __init__(self, config: TrainConfig, n_devices: Optional[int] = None,
                 device="cuda", devices: Optional[Sequence] = None):
        self.cfg = config
        self.devices = train_devices(n_devices, device, devices)
        self.n_devices = len(self.devices)
        self.device = self.devices[0]
        # the rank of a multi-device run (parallel.distributed.Rank), set
        # in each rank's process; None on one device
        self.ctx = None

    @property
    def is_main(self) -> bool:
        """Whether this process validates, logs and writes checkpoints."""
        return self.ctx is None or self.ctx.rank == 0

    # ----------------------------------------------------------- phases

    def run(self, resume: bool = False) -> List[RunInfo]:
        """Run all phases and return each run phase's RunInfo (rank 0's on
        several devices). With resume=True, completed phases are skipped
        and the first incomplete phase continues from its last checkpoint
        (the reference has no training resume at all — run_train.py:176
        TODO).

        On several devices the ranks run with no overall time limit: a
        rank that dies ends the run at once, and a collective waits at
        most `distributed.COLLECTIVE_TIMEOUT_S`."""
        if self.n_devices > 1 and self.ctx is None:
            return distributed.run_ranks(
                _train_rank, self.devices,
                (self.cfg, self.devices, resume), timeout_s=None)[0]
        np.random.seed(self.cfg.seed)
        prev_dir = None
        infos = []
        n_phases = len(self.cfg.phases)
        for idx, phase in enumerate(self.cfg.phases):
            save_dir = (self.cfg.log_dir if n_phases == 1
                        else os.path.join(self.cfg.log_dir, f"{idx:02d}"))
            if resume:
                last = last_checkpoint(save_dir, allow_missing=True) \
                    if os.path.isdir(save_dir) else None
                done = last is not None and _epoch_of(last) >= phase.nr_epochs
                if done:
                    print(f"phase {idx}: complete ({last}), skipping")
                    prev_dir = save_dir
                    continue
                infos.append(self.run_once(phase, save_dir, prev_dir,
                                           resume=True))
            else:
                infos.append(self.run_once(phase, save_dir, prev_dir))
            prev_dir = save_dir
        return infos

    # ------------------------------------------------------------ setup

    def _build_model(self, phase):
        mcfg = HoVerNetConfig(
            mode=self.cfg.model_mode, nr_types=self.cfg.nr_types,
            width=self.cfg.width,
        )
        return HoVerNet(mcfg, generator=torch.Generator().manual_seed(
            self.cfg.seed))

    def _load_pretrained(self, phase, model, prev_dir):
        pretrained = phase.pretrained
        if pretrained is None:
            return
        if pretrained == -1:
            path = last_checkpoint(prev_dir)
        else:
            path = pretrained
        print(f"phase pretrained: {path}")
        if str(path).endswith((".tar", ".pth", ".pt")):
            incoming = ckpt.load_torch_tar(path)
        elif str(path).endswith(".npz"):
            # ImageNet preact-ResNet50 encoder (or full-model TF export);
            # must cover the whole encoder or load_pretrained_npz raises
            incoming = ckpt.load_pretrained_npz(path, model.cfg)
        else:
            # the JAX package's msgpack, its matching variables (the JAX
            # trainer's partial merge)
            variables, _ = ckpt.load_checkpoint(path)
            incoming = ckpt.state_dict_from_jax(variables, model.cfg,
                                                partial=True)
            known = {p for _, p, _ in ckpt.name_map(model.cfg)}
            unknown = [p for p in ckpt.variable_paths(variables)
                       if p not in known]
            if unknown:
                print("unknown variables:", unknown[:8],
                      "..." if len(unknown) > 8 else "")
        merge_partial(model, incoming)

    def _get_loader(self, mode, phase):
        dirs = (self.cfg.train_dir_list if mode == "train"
                else self.cfg.valid_dir_list)
        dataset = PatchDataset(dirs)
        print(f"dataset {mode}: {len(dataset)}")
        workers = 0 if self.cfg.debug else (
            self.cfg.nr_procs_train if mode == "train" else self.cfg.nr_procs_valid
        )
        # training: the global batch, this rank's shard of it; validation
        # runs on rank 0 alone, over the whole set
        shard = ({} if mode != "train" or self.ctx is None else
                 {"rank": self.ctx.rank, "world_size": self.ctx.world_size})
        return TrainLoader(
            dataset, batch_size=phase.batch_size[mode] * self.n_devices,
            input_shape=self.cfg.act_shape, mask_shape=self.cfg.out_shape,
            mode=mode, with_type=self.cfg.type_classification,
            num_workers=workers, seed=self.cfg.seed, **shard,
        )

    # -------------------------------------------------------------- run

    def run_once(self, phase, save_dir, prev_dir=None, resume: bool = False):
        group = None if self.ctx is None else self.ctx.group
        writes_logs = self.cfg.logging and self.is_main
        if writes_logs:
            if not resume:
                if os.path.isdir(save_dir):
                    shutil.rmtree(save_dir)
            os.makedirs(save_dir, exist_ok=True)
            if not os.path.exists(f"{save_dir}/stats.json"):
                with open(f"{save_dir}/stats.json", "w") as f:
                    json.dump({}, f)
            log_info = {"json_file": f"{save_dir}/stats.json",
                        "tfwriter": _summary_writer(save_dir)}
        else:
            log_info = {}

        model = self._build_model(phase)
        train_loader = self._get_loader("train", phase)
        valid_loader = (self._get_loader("valid", phase) if self.is_main
                        else None)

        steps_per_epoch = max(train_loader.steps_per_epoch(), 1)
        tx, schedule = make_optimizer(
            lr=phase.lr, step_epochs=phase.lr_step_epochs,
            steps_per_epoch=steps_per_epoch, gamma=phase.lr_gamma,
        )
        self._load_pretrained(phase, model, prev_dir)
        state = init_train_state(model, tx, self.device)

        start_epoch = 0
        if resume and os.path.isdir(save_dir):
            last = last_checkpoint(save_dir, allow_missing=True)
            if last:
                desc, opt_state, step = (
                    ckpt.load_train_msgpack(last, model)
                    if last.endswith(".msgpack")
                    else ckpt.load_train_tar(last))
                model.load_state_dict(desc, strict=True)
                if opt_state is not None:
                    state.optimizer.load_state_dict(opt_state)
                state.step = step
                start_epoch = _epoch_of(last)
                print(f"resumed from {last} (epoch {start_epoch})")
        if group is not None:
            # every rank starts from rank 0's parameters and buffers
            distributed.broadcast_(distributed.module_tensors(model), group)

        run_info = RunInfo(model, tx, schedule, state)

        train_step = make_train_step(
            model, schedule, freeze_encoder=phase.freeze_encoder,
            loss_weights=phase.loss_weights, group=group,
        )
        eval_step = make_eval_step(model)

        nr_types = self.cfg.nr_types
        device = self.device

        def train_run_step(batch, engine_state):
            # batches arrive on the device (PrefetchLoader copies batch
            # k+1 on a side stream under the compute of batch k)
            t0 = time.perf_counter()
            run_info.train_state, (terms, viz) = train_step(
                run_info.train_state, batch
            )
            ema = {k: float(v) for k, v in terms.items()}
            run_info.step_s.append(time.perf_counter() - t0)
            if self.ctx is not None:
                self.ctx.mark("first step")
            run_info.last_grad_norm = ema.get("grad_norm")
            run_info.losses.append(ema["overall_loss"])
            # raw viz: 2 samples, pulled to the host at epoch end
            n = min(2, batch["img"].shape[0])
            raw = {
                "img": batch["img"][:n].cpu().numpy(),
                "np": (batch["np_map"][:n].cpu().numpy(),
                       viz["np"][:n].cpu().numpy()),
                "hv": (batch["hv_map"][:n].cpu().numpy(),
                       viz["hv"][:n].cpu().numpy()),
            }
            if "tp" in viz:
                raw["tp"] = (batch["tp_map"][:n].cpu().numpy(),
                             viz["tp"][:n].cpu().numpy())
            return {"EMA": ema, "raw": raw}

        def valid_run_step(batch, engine_state):
            imgs = torch.from_numpy(np.asarray(batch["img"])).to(device)
            out = {k: v.cpu().numpy() for k, v in
                   eval_step(run_info.train_state.model, imgs).items()}
            raw = {
                "imgs": batch["img"],
                "true_np": batch["np_map"],
                "true_hv": batch["hv_map"],
                "prob_np": out["prob_np"],
                "pred_hv": out["pred_hv"],
            }
            if nr_types is not None:
                raw["true_tp"] = batch["tp_map"]
                raw["pred_tp"] = out["pred_tp"]
            return {"raw": raw}

        prefetch = PrefetchLoader(train_loader, device)
        train_engine = RunEngine("train", prefetch, train_run_step,
                                 run_info, log_info, progress=self.is_main)
        train_engine.state.logging = writes_logs
        train_engine.state.log_dir = save_dir
        train_engine.state.curr_epoch = start_epoch
        if self.is_main:
            self._wire_callbacks(train_engine, valid_run_step, valid_loader,
                                 run_info, log_info, writes_logs, save_dir)
        if group is not None:
            # the other ranks wait while rank 0 validates and saves
            train_engine.add_event_handler(Events.EPOCH_COMPLETED,
                                           cb.Barrier(group))

        t0 = time.perf_counter()
        try:
            train_engine.run(phase.nr_epochs - start_epoch)
        finally:
            run_info.run_s = time.perf_counter() - t0
            run_info.wait_s = prefetch.wait_s
            train_loader.close()
            if valid_loader is not None:
                valid_loader.close()
            writer = log_info.get("tfwriter")
            if writer is not None:
                writer.close()
        if group is not None and not distributed.replicas_equal(
                distributed.module_tensors(model), group):
            raise RuntimeError("the ranks' parameters or buffers differ "
                               "after the phase")
        return run_info

    def _wire_callbacks(self, train_engine, valid_run_step, valid_loader,
                        run_info, log_info, writes_logs, save_dir):
        """The reference's callbacks, and the validation engine that the
        train engine triggers at the end of each epoch."""
        nr_types = self.cfg.nr_types
        valid_engine = RunEngine("valid", valid_loader, valid_run_step,
                                 run_info, log_info)
        valid_engine.state.logging = writes_logs
        valid_engine.state.log_dir = save_dir

        trigger = cb.TriggerEngine("valid")
        trigger.triggered_engine = valid_engine
        for event, cbs in {
            Events.STEP_COMPLETED: [cb.ScalarMovingAverage()],
            Events.EPOCH_COMPLETED: [
                cb.TrackLr(), cb.PeriodicSaver(),
                cb.VisualizeOutput(
                    lambda raw: viz_train_step_output(raw, nr_types)
                ),
                cb.LoggingEpochOutput(), trigger, cb.ScheduleLr(),
            ],
        }.items():
            for c in cbs:
                train_engine.add_event_handler(event, c)
        for event, cbs in {
            Events.STEP_COMPLETED: [cb.AccumulateRawOutput()],
            Events.EPOCH_COMPLETED: [
                cb.ProcessAccumulatedRawOutput(
                    lambda acc: proc_valid_step_output(acc, nr_types)
                ),
                cb.LoggingEpochOutput(),
                # best-valid-metric checkpoint: the reference ships this
                # callback but never wires it (callbacks/base.py:105,
                # opt.py engine spec) — here it is on by default, after
                # LoggingEpochOutput so stats.json holds this epoch
                cb.ConditionalSaver("valid-np_dice", comparator=">="),
            ],
        }.items():
            for c in cbs:
                valid_engine.add_event_handler(event, c)


def _summary_writer(log_dir):
    """tensorboardX's SummaryWriter, or None (with one printed line) where
    tensorboardX is not installed; stats.json and the checkpoints never
    depend on it."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        print("tensorboardX is not installed: no TensorBoard events "
              "(stats.json is still written)")
        return None
    return SummaryWriter(log_dir=log_dir)


def _epoch_of(path) -> int:
    return int(os.path.basename(path).split("=")[1].split(".")[0])


def last_checkpoint(log_dir, allow_missing=False):
    """Highest-epoch checkpoint recorded in a phase dir (the reference
    reads stats.json for this, run_train.py:164-174; the glob makes
    resume work even if stats.json is missing): the port's
    `net_epoch=N.tar` or the JAX trainer's `net_epoch=N.msgpack`, the
    `.tar` where both hold the highest epoch."""
    paths = (glob.glob(f"{log_dir}/net_epoch=*.tar")
             + glob.glob(f"{log_dir}/net_epoch=*.msgpack"))
    if not paths:
        if allow_missing:
            return None
        raise FileNotFoundError(f"no checkpoints under {log_dir}")
    return max(paths, key=lambda p: (_epoch_of(p), p.endswith(".tar")))


def merge_partial(model: torch.nn.Module, incoming: Dict[str, torch.Tensor]
                  ) -> Tuple[List[str], List[str]]:
    """Load the matching entries of `incoming` into `model`, keep the
    init values elsewhere, and report both (the reference's strict=False
    load, run_train.py:210-215); a shape mismatch raises. Returns
    (missing, unknown) keys. BN's `num_batches_tracked` counters are not
    reported missing."""
    current = model.state_dict()
    missing = [k for k in current if k not in incoming
               and not k.endswith("num_batches_tracked")]
    unknown = [k for k in incoming if k not in current]
    for k, v in incoming.items():
        if k in current and tuple(v.shape) != tuple(current[k].shape):
            raise ValueError(
                f"pretrained shape mismatch at {k}: {tuple(v.shape)} vs "
                f"model {tuple(current[k].shape)}")
    model.load_state_dict({k: v for k, v in incoming.items()
                           if k in current}, strict=False)
    for name, keys in (("missing", missing), ("unknown", unknown)):
        if keys:
            print(f"{name} variables:", keys[:8],
                  "..." if len(keys) > 8 else "")
    return missing, unknown
