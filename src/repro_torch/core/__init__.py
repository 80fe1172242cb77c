"""The search side of the port: the circuit IR, the exact benchmarks, the
SHARED template, light synthesis, the exhaustive miter, the unified engine
API (:mod:`.engine`) and the tensorized population search
(:mod:`.tensor_search`) on the ``template_eval`` kernel."""
