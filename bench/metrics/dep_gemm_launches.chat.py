"""Expert-GEMM launches the DEP walk makes per decode step, from the
programs the window ran (``EngineStats.programs``): MoE layers x r1 x
r2 of each decode program, averaged over the window's decode steps."""


def read(w):
    n = [w.served["num_layers"] * p.graph.r1 * p.graph.r2
         for phase, p in w.programs if phase == "decode"]
    return sum(n) / len(n) if n else None
