"""The program's own share of set-up, as the process recorded it
(``ops/build.py``): the kernel library's freshness check, load and binding
(``load_seconds``) and each entry point's first call (``first_call_seconds``:
the card loads the kernel's module and launches it first there). Nothing
where the process called no kernel, where it compiled the library
(``rebuilt``: that set-up is the compile's), or where the program records
none of it."""


def read(run):
    from genome_downsampler_tpu_torch.ops import build  # loaded by the run's solves

    calls = getattr(build, "first_call_seconds", None)
    if not calls or build.rebuilt:
        return None
    return build.load_seconds + sum(calls.values())
