"""Per-layer metrics, one file each, named as the metric: ``read(obs)``
returns the metric's value, or None where the run holds nothing for it
to read (the harness then leaves the metric out of the line). A metric
that counts a call's work names the span of that call (``SPAN``) and
gives ``count(args, kwargs)``, which reads only the call's arguments."""
