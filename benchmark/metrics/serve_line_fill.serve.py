"""Valid code lines over the rows the serving loop's per-line encoder ran,
%, from the program's host counts (``train/predict.line_counters``: line
slots, valid lines of the chunks' own rows, rows encoded), summed over
every chunk ``serve`` ran in the run, set-up's warm-up of each bucket
included. The note gives the line slots, the rows an encoder over every
slot would run. None where the program keeps no such counts."""


def read(ctx):
    if ctx["raw"]["kind"] != "serve":
        return None
    try:
        from mvuld_tpu_torch.train.predict import line_counters
    except ImportError:
        return None
    c = line_counters()
    if c["encoded"] <= 0:
        return None
    ctx["notes"].append(
        f"serve_line_fill.serve: {c['lines']} valid lines in "
        f"{c['encoded']} encoded rows of {c['slots']} line slots "
        f"({c['lines'] / c['slots']:.6f} of the slots)")
    return 100.0 * c["lines"] / c["encoded"]
