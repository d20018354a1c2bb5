"""Shared by the stage readers: a stage's milliseconds a unit (step or
pass) in the traced window's ``StageTimer`` part, summed over its marks."""


def stage_ms(ctx: dict, name: str):
    staged = ctx["stages"]
    times = staged["ms"].get(name)
    if not times or not staged["units"]:
        return None
    return sum(times) / staged["units"]
