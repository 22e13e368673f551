"""The window's share of the card's peak: the operations its iterations
need (portbench/counts/step.py, from the configuration's shapes alone)
over the window's wall time and the peak of the cell's precision."""

from portbench.counts import peaks, step


def read(run):
    w = run["window"]
    if not w["iterations"]:
        return None
    traffic = run["traffic"]
    flops = sum(step.iteration_flops(run["config"], run["batch"], traffic["mcmc_steps"],
                                     it["adapted"], traffic["optimizer"])
                for it in run["window_iterations"])
    return 100.0 * flops / (w["wall_s"] * peaks.PEAK_FLOPS[run["precision"]])
