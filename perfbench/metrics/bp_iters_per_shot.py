"""bp_iters_per_shot: BP iterations per shot-basis, the shot-iterations
the program's BP returned (``bp.shot_iterations``, K1's ``iterations``)
over the shot-bases it decoded (``bp.shots``), over the window's
dispatches (``run.telemetry``; program counter). Where the reference
counted the same dispatches (``run.iterations``), a note says whether the
program's count equals it."""


def read(run):
    exp = getattr(run, "telemetry", None)
    if not exp:
        return None
    ids = {d.index for d in run.dispatches}
    per = {}
    for s in exp["spans"]:
        if s["name"] == "bp" and s["dispatch"] in ids:
            its, shots = per.get(s["dispatch"], (0, 0))
            per[s["dispatch"]] = (
                its + s["counters"].get("bp.shot_iterations", 0),
                shots + s["counters"].get("bp.shots", 0))
    shots = sum(v[1] for v in per.values())
    if not shots:
        return None
    checked = [i for i in run.iterations if i in per]
    if checked:
        ref = {i: int(sum(int(v.sum()) for v in run.iterations[i].values()))
               for i in checked}
        same = all(per[i][0] == ref[i] for i in checked)
        run.notes.append(
            f"bp_iters_per_shot: the program's shot-iterations "
            f"{'equal' if same else 'DIFFER FROM'} the reference's on "
            f"{len(checked)} checked dispatches "
            f"({', '.join(f'{per[i][0]} / {ref[i]}' for i in checked)})")
    return sum(v[0] for v in per.values()) / shots
