"""One reader a metric, named as the metric: ``KIND``, ``UNIT`` and
``read(run)``, which returns None where the run has nothing to read."""
