"""torch.cuda.max_memory_allocated over the whole run, GiB."""


def read(ctx):
    if ctx["raw"]["kind"] != "train":
        return None
    return ctx["peak_bytes"] / 2 ** 30
