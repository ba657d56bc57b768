"""The benchmark of siriltpu_torch: one run of one cell (a configuration
under a traffic mix) prints one result line. See README.md."""
