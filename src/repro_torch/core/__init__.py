"""Hub core of the port (this slice: the admission/wave scheduler
helpers the serving engine uses)."""
from repro_torch.core.scheduler import AITask, EdgeScheduler
from repro_torch.unported import not_ported

EdgeAIHub = not_ported("repro.core.EdgeAIHub", "A.10 (core)")
default_home = not_ported("repro.core.default_home", "A.10 (core)")
Orchestrator = not_ported("repro.core.Orchestrator", "A.10 (core)")
TaskSpec = not_ported("repro.core.TaskSpec", "A.10 (core)")
