"""Host-side fault tolerance of the port: the heartbeat monitor and the
crash-reclaimable file leases the sweep's cell store and the prediction
cache's training lock build on, and the straggler and re-mesh planners."""
