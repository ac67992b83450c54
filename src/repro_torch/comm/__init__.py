"""Communication schedules.  ``schedules`` synthesizes and prices
per-topology collectives on the host; the reference's device collectives
(``comm.jaxcoll``) are not ported yet (ROADMAP Queue 1, item 7)."""
