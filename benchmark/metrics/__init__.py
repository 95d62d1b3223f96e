"""One reader a metric: ``<name>.py`` with ``read(window)``, which returns the
number or None where the run has nothing to read."""
