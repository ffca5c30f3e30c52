"""The share of the seeded jet's backwards (B3b) that computed a seed
cotangent no caller asked for: the program's counter ``SEED_GRADS``
(``kernels/fused_jet_vjp.py``), ``unneeded`` over all, over the run's
process, in percent.  None for a program without the counter, or one that
ran no such backward."""


def read(run):
    try:
        from pinn_elastodynamics_torch.kernels import fused_jet_vjp
    except ImportError:
        return None
    counts = getattr(fused_jet_vjp, "SEED_GRADS", None)
    if not counts or not sum(counts.values()):
        return None
    return 100.0 * counts["unneeded"] / sum(counts.values())
