"""assembly_wall_s: the traced window's wall on the host's clock over the
assemblies it held, seconds per assembly. The traced window runs under the
profiler, so this reads above an untraced window's wall."""


def read(ctx):
    return ctx["window_s"] / ctx["assemblies"] if ctx.get("assemblies") else None
