"""The async rollout system: the gserver manager and its fleet health
plane, the chunked partial-rollout client, the rollout worker, the
rollout -> trainer stream and the trainer's staleness-ordered buffer."""
