"""The share of the closed-form hard-BC factors' lookups that read D's and
P's results back from the model's store: the program's counter
``FACTOR_JETS`` (``models/analytic_bc.py``), ``hit`` over all, over the
run's process, in percent.  None for a program without the counter, or
one that looked nothing up."""


def read(run):
    try:
        from pinn_elastodynamics_torch.models import analytic_bc
    except ImportError:
        return None
    counts = getattr(analytic_bc, "FACTOR_JETS", None)
    if not counts or not sum(counts.values()):
        return None
    return 100.0 * counts["hit"] / sum(counts.values())
