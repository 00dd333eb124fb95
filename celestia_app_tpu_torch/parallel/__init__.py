"""Batched, streamed and sharded block work: the port of
celestia_app_tpu/parallel (the device mesh, the sharded pipeline, the mesh
engine and its batched dispatch, streaming and the multi-host dryrun)."""
