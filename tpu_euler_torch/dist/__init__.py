"""The sharded mode: ranks and collectives, the hash-owner exchange, sharded
counting and the pipeline over them (counterpart of ``tpu_euler/dist``)."""
