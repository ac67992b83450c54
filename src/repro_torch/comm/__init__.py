"""Communication schedules.  ``schedules`` synthesizes and prices
per-topology collectives on the host; ``torchcoll`` runs the reference's
device collectives (``repro.comm.jaxcoll``: ring, recursive-doubling and
int8 allreduce, flood broadcast) over ``torch.distributed``
point-to-point transfers."""
