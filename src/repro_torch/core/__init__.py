"""Core library the engine runs on: pricing, the burstable-network and
storage models with the metered ObjectStore, S3 partition scaling,
break-even analysis, worker pools, the stage scheduler and the
burst-aware planner."""
