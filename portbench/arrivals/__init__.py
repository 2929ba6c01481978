"""Arrival shapes of the load generator, one module each, found by the
``arrival`` name of a traffic mix: ``run(plan, client, rng, announce)``
drives the requests and announces the window's opening."""
