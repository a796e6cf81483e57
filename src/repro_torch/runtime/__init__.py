"""Runtime pieces the port needs so far: the cluster-churn events."""
