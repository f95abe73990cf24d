"""crossover_accept_share (%): of the lanes the vertex crossover tried over
the whole run (set-up, window and traced stretch; every crossover of every
call, the first and the final), the share it accepted as optimal vertices.
The program sums both counts on the device
(``pycllp_tpu_torch.solvers.hsd.CROSSOVER_LANES``, (tried, accepted) per
device and crossover), and they are read once here, after the run.
Nothing to read where the program has no such counter or tried no lane."""

from lpbench import program


def read(run):
    try:
        lanes = program.resolve("pycllp_tpu_torch.solvers.hsd.CROSSOVER_LANES")
    except AttributeError:
        return None
    tried = accepted = 0
    for t in lanes.values():
        a, b = (int(v) for v in t.tolist())
        tried, accepted = tried + a, accepted + b
    return 100.0 * accepted / tried if tried else None
