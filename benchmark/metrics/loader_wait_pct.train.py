"""The loader's share of a train step, %: the seconds the step waited for
its batch (`PrefetchLoader.wait_s`, the loader workers' augmentation and
targets not hidden under the step before) over the seconds of the steps,
summed over the window."""


def read(facts):
    step = sum(facts["window_step_s"]) + sum(facts["window_wait_s"])
    return 100.0 * sum(facts["window_wait_s"]) / step if step > 0 else None
