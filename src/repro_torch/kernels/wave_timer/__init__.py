"""Wave timer: %globaltimer stamp kernels, wrappers, plain versions, tick unit."""
