"""Runtime pieces the port needs so far: the cluster-churn events, the
execution backends and epoch loop (``backend``), and transfer counting."""
