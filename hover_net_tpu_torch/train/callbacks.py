"""Callback set (run_utils/callbacks/base.py + logging.py parity).

Counterpart of hover_net_tpu/train/callbacks.py (same names, same
behaviour), with the checkpoints in the reference's own `.tar` format.
Differences from the reference, on purpose:
- stats.json is written atomically (the reference notes its
  read-modify-write "may corrupt", logging.py:143-145);
- the learning rate is set per update from the trainer's
  `schedule(step)`, so ScheduleLr is a no-op kept for wiring parity;
  TrackLr reads the schedule at the current step;
- `Barrier` ends each epoch of a multi-device run: the ranks other than
  0 wait there while rank 0 runs the other callbacks (validation, logs,
  checkpoints).
"""

from __future__ import annotations

import json
import operator
import os
import tempfile

import numpy as np

from ..parallel.distributed import barrier


class BaseCallback:
    engine_trigger = False

    def run(self, state, event):
        raise NotImplementedError


class TrackLr(BaseCallback):
    def run(self, state, event):
        info = state.run_info
        if info is None or info.lr_schedule is None:
            return
        lr = float(info.lr_schedule(info.train_state.step))
        state.tracked_step_output["scalar"]["lr-net"] = lr


class ScheduleLr(BaseCallback):
    """No-op: the train step sets the LR from the schedule per update."""

    def run(self, state, event):
        return


class Barrier(BaseCallback):
    """Wait for every rank of the process group."""

    def __init__(self, group):
        self.group = group

    def run(self, state, event):
        barrier(self.group)


class TriggerEngine(BaseCallback):
    def __init__(self, triggered_engine_name, nr_epoch=1):
        self.engine_trigger = True
        self.triggered_engine_name = triggered_engine_name
        self.triggered_engine = None
        self.nr_epoch = nr_epoch

    def run(self, state, event):
        self.triggered_engine.run(
            chained=True, nr_epoch=self.nr_epoch, shared_state=state
        )


class PeriodicSaver(BaseCallback):
    """Write `net_epoch={N}.tar` every n epochs
    (callbacks/base.py:76-101)."""

    def __init__(self, per_n_epoch=1):
        self.per_n_epoch = per_n_epoch

    def run(self, state, event):
        if not state.logging or state.curr_epoch % self.per_n_epoch != 0:
            return
        state.run_info.save_checkpoint(
            f"{state.log_dir}/net_epoch={state.curr_epoch}.tar"
        )


class ConditionalSaver(BaseCallback):
    """Save `net_best=[metric].tar` when the tracked metric improves
    over all epochs recorded in stats.json (callbacks/base.py:105-154)."""

    def __init__(self, metric_name, comparator=">="):
        self.metric_name = metric_name
        self.comparator = comparator

    def run(self, state, event):
        if not state.logging:
            return
        ops = {">": operator.gt, "<": operator.lt,
               ">=": operator.ge, "<=": operator.le}
        op = ops[self.comparator]
        best = -float("inf") if self.comparator in (">", ">=") else float("inf")
        with open(state.log_info["json_file"]) as f:
            stats = json.load(f)
        # when chained under the train engine (valid metrics), epochs in
        # stats.json are the PARENT's
        epoch = (state.global_state.curr_epoch
                 if state.global_state is not None else state.curr_epoch)
        current = stats.get(str(epoch), {}).get(self.metric_name)
        for ep, epoch_stat in stats.items():
            if ep == str(epoch):
                continue
            if self.metric_name in epoch_stat and op(epoch_stat[self.metric_name], best):
                best = epoch_stat[self.metric_name]
        if current is None or not op(current, best):
            return
        state.run_info.save_checkpoint(
            f"{state.log_dir}/net_best=[{self.metric_name}].tar"
        )


class AccumulateRawOutput(BaseCallback):
    def run(self, state, event):
        raw = state.step_output["raw"]
        acc = state.epoch_accumulated_output
        for key, value in raw.items():
            acc.setdefault(key, []).extend(list(value))


class ScalarMovingAverage(BaseCallback):
    """EMA (alpha=0.95) over per-step scalar outputs
    (callbacks/base.py:172-198)."""

    def __init__(self, alpha=0.95):
        self.alpha = alpha
        self.tracking = {}

    def run(self, state, event):
        for key, value in state.step_output["EMA"].items():
            value = float(value)
            if key in self.tracking:
                self.tracking[key] = (
                    self.tracking[key] * self.alpha + (1 - self.alpha) * value
                )
            else:
                self.tracking[key] = value
        state.tracked_step_output["scalar"] = dict(self.tracking)


class ProcessAccumulatedRawOutput(BaseCallback):
    def __init__(self, proc_func, per_n_epoch=1):
        self.per_n_epoch = per_n_epoch
        self.proc_func = proc_func

    def run(self, state, event):
        state.tracked_step_output = self.proc_func(state.epoch_accumulated_output)


class VisualizeOutput(BaseCallback):
    def __init__(self, proc_func):
        self.proc_func = proc_func

    def run(self, state, event):
        state.tracked_step_output["image"]["output"] = self.proc_func(
            state.step_output["raw"]
        )


class LoggingEpochOutput(BaseCallback):
    """Serialize tracked outputs to console, stats.json (atomic) and
    TensorBoard (logging.py:87-161 behaviours)."""

    def __init__(self, per_n_epoch=1):
        self.per_n_epoch = per_n_epoch

    def run(self, state, event):
        if not state.logging or state.curr_epoch % self.per_n_epoch != 0:
            return
        # when chained (valid engine), log under the parent's epoch
        epoch = (state.global_state.curr_epoch
                 if state.global_state is not None else state.curr_epoch)
        prefix = "valid" if state.global_state is not None else "train"

        scalars = {k: float(v) for k, v in
                   state.tracked_step_output["scalar"].items()}
        for name, value in scalars.items():
            print(f"  {prefix}-{name:<24s}: {value:.5f}")

        json_file = state.log_info.get("json_file")
        if json_file:
            with open(json_file) as f:
                stats = json.load(f)
            entry = stats.setdefault(str(epoch), {})
            entry.update({f"{prefix}-{k}": v for k, v in scalars.items()})
            d = os.path.dirname(os.path.abspath(json_file))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(stats, f)
            os.replace(tmp, json_file)

        writer = state.log_info.get("tfwriter")
        if writer is not None:
            for name, value in scalars.items():
                writer.add_scalar(f"{prefix}-{name}", value, epoch)
            for name, img in state.tracked_step_output["image"].items():
                writer.add_image(f"{prefix}-{name}",
                                 np.asarray(img).transpose(2, 0, 1), epoch)
            writer.flush()


class LoggingGradient(BaseCallback):
    """Track global gradient norm per step (the reference's
    param/gradient histograms, logging.py:16-83, condensed to the
    useful scalar; disabled by default in the phase spec, like there)."""

    def run(self, state, event):
        info = state.run_info
        if info is None or info.last_grad_norm is None:
            return
        state.tracked_step_output["scalar"]["grad_norm"] = float(
            info.last_grad_norm
        )
