"""Model families ported so far: BERT (encoder and causal decoder, MoE
layers included), the encoder as pipeline stages (``bert_pipeline``),
ResNet (``resnet``), the DeepSpeech-family acoustic model (``speech``),
detection: EfficientDet (``efficientdet``), PointPillars
(``pointpillars``) and COCO-style AP (``detection_eval``), and the Apollo
driving stack: perception's tracker pipeline (``perception``),
``prediction``, ``scenario``, ``planning``, ``control``,
``localization`` and ``routing``."""
from tosem_tpu_torch.models.control import (ControlComponent, PidGains,
                                            PlanningComponent,
                                            VehicleParams,
                                            build_driving_pipeline,
                                            lateral_gain, lqr_gain,
                                            track_candidates,
                                            track_trajectory)
from tosem_tpu_torch.models.localization import (EkfParams,
                                                 LocalizationComponent,
                                                 dead_reckon, ekf_localize,
                                                 rtk_interpolate)
from tosem_tpu_torch.models.perception import (DetectionComponent,
                                               GreedyIouTracker,
                                               TrackerComponent)
from tosem_tpu_torch.models.planning import (obstacles_from_tracks,
                                             plan_path, plan_speed,
                                             solve_corridor)
from tosem_tpu_torch.models.prediction import (PredictionComponent,
                                               TrackVelocityEstimator,
                                               predict_rollout,
                                               swept_obstacles)
from tosem_tpu_torch.models.resnet import (BottleneckBlock, ResNet,
                                           resnet18_ish, resnet50)
from tosem_tpu_torch.models.routing import (Lane, LaneGraph,
                                            RoutingComponent, a_star,
                                            batched_sssp, route_reference)
from tosem_tpu_torch.models.scenario import (EMERGENCY_STOP, LANE_FOLLOW,
                                             OBSTACLE_AVOID,
                                             ScenarioComponent,
                                             ScenarioManager)

__all__ = ["BottleneckBlock", "ResNet", "resnet18_ish", "resnet50",
           "plan_path", "plan_speed", "obstacles_from_tracks",
           "solve_corridor", "DetectionComponent", "TrackerComponent",
           "GreedyIouTracker", "Lane", "LaneGraph", "RoutingComponent",
           "a_star", "batched_sssp", "route_reference", "predict_rollout",
           "swept_obstacles", "TrackVelocityEstimator",
           "PredictionComponent", "ScenarioManager", "ScenarioComponent",
           "LANE_FOLLOW", "OBSTACLE_AVOID", "EMERGENCY_STOP",
           "VehicleParams", "PidGains", "lqr_gain", "lateral_gain",
           "track_trajectory", "track_candidates", "PlanningComponent",
           "ControlComponent", "build_driving_pipeline", "EkfParams",
           "ekf_localize", "dead_reckon", "rtk_interpolate",
           "LocalizationComponent"]
