"""Functions answered in the window over its time."""


def read(ctx):
    raw = ctx["raw"]
    if raw["kind"] != "serve":
        return None
    return raw["functions"] / raw["window_s"]
