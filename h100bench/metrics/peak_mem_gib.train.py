"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` at the window's
close, after ``reset_peak_memory_stats()`` at the start of set-up: the
weights, optimizer state or page pool, and the largest activations or
scratch of the run."""


def read(ctx):
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 2 ** 30
