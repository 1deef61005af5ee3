"""The port's gateway tier: so far only the fleet-tagged trace format
(``traces``), which the single-fleet ``serve`` reads to refuse a
multi-fleet trace. The tier itself (routing, workers, snapshots, HTTP) is
ROADMAP A12b.
"""
