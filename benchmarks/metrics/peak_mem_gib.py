"""peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated()`` over set-up
and window, read when the window closes, before the reference runs."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
