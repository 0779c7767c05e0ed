"""Model families: everything of the benchmark that depends on how a model is
built, one module per family, found by the name a configuration gives under
``family`` (``manifest.family``: ``families/<name>.py`` of the data
directory, else of the benchmark).  A configuration of a new family is added
with its module; no other file of the benchmark changes.

A family module is the reference's half, plain float32 torch that imports
nothing of the measured program.  It supplies:

  PROGRAM            the name of its program half, a module found the same
                     way (a file ending in ``_program.py``);
  FAMILIES           the names of its leaf families, in the order the check
                     reports them (``grad.<f>``, ``change.<f>``);
  leaves(spec)       (path, shape, init bound) of every trainable leaf, in the
                     order ``reference.model.init_weights`` draws them;
  leaf_families(spec)            {path: leaf family};
  user_loss(spec, params, inputs, targets, rec, quant)
                     one user's scalar loss on its micro-batch; it records
                     each running statistic's batch values in ``rec.stats``;
  running_stats(spec)            {key: (shape, start value)} of the running
                     statistics, in order; empty where the model has none;
  update_running(spec, running, stats)
                     moves them in place by one step's users' batch values
                     ({rec key: tensors with a leading users axis});
  unit_dims(spec)    {path: order of the leaf's axes} where a leaf is flattened
                     into its compression unit in another order than its own
                     (row-major for every leaf not named);
  flops_per_sample(spec)         the forward and backward operations of one
                     training sample, for ``step_mfu``;
  Data               (optional) the training set of the traffic's ``data``,
                     made from the seed: ``Data(data, seed).batch(step, users,
                     batch, device)`` gives the step's (inputs, targets) with a
                     leading users axis; ``reference.step.Data`` otherwise.

The program half imports the program (``gqx_torch``) inside its functions:

  config_fields(spec, traffic, seed)  the data fields of ``GQConfig``;
  build(spec, config, pipeline)       the program's model, on the host;
  leaf_paths(model)                   {parameter name: the leaf's path};
  running_buffers(model, paths)       {key of running_stats: the buffer}.

``images`` holds what the image families share (batch norm, SAME pads, the
synthetic images); ``image_program`` is their program half.
"""
