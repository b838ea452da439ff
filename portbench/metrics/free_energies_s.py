"""free_energies_s: the mean wall of ``compute_free_energy_differences()`` over
the traced jobs, from the harness's span around the call (host clock,
fenced by ``torch.cuda.synchronize()``).  Layer: ``mbar.py``'s Theta and
free energies.  Moves ``job_s``."""


def read(run):
    walls = [j["spans"]["free_energies"] for j in run.jobs if "free_energies" in j["spans"]]
    return sum(walls) / len(walls) if walls else None
