/* Guide-tree construction: recursive bisecting 2-means over the anchor
 * distance embedding, with exact UPGMA below the 50-sequence threshold.
 *
 * Reference semantics (lib/src/bisectingKmeans.c):
 *   - split2 Lloyd iterations with epsilon float compares, alternating
 *     tie assignment and the degenerate-split fallback (:766-971)
 *   - 40 seeded tries in rounds of 4, keep best SSE, stop early on no
 *     improvement (:318-363)
 *   - UPGMA with +0.001 distance nudge below threshold (:974-1053)
 *   - post-order internal labels, pre-order task emission (:1067-1114)
 *
 * Float note: the reference accumulates the k-means L2 distances with an
 * 8-lane SIMD kernel and a fixed horizontal-add tree
 * (euclidean_dist.c:159-206); kt::edist_lanes8 reproduces that exact
 * summation order in scalar code.
 *
 * The build has two halves.  The splits (split_down) read only the anchor
 * embedding, so they fix the leaf sets before any pair distance exists:
 * kt_tree_leaf_sets returns them, and a caller that computes the sets'
 * pair distances elsewhere (on the card) hands them back to kt_build_tree,
 * which then joins (join_up) without computing any.  Left to itself,
 * kt_build_tree computes each distinct unordered pair of a leaf set once
 * (leaf_distances).
 *
 * kt_build_tree also measures itself (TreeStats): the steady-clock seconds
 * of the k-means rounds, of the leaves' pair distances and of their UPGMA
 * joins, and counts the pair distances it computed and the distinct
 * unordered pairs the UPGMA needs.  It counts per leaf set, outside the
 * pair loop.
 */
#include "kt_api.h"

#include <algorithm>
#include <cfloat>
#include <chrono>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kUpgmaThreshold = 50;  /* KALIGN_KMEANS_UPGMA_THRESHOLD */

struct TreeNode {
  TreeNode* left = nullptr;
  TreeNode* right = nullptr;
  int id = -1;
};

/* kt_build_tree's stats_out, in this order */
struct TreeStats {
  double splits_s = 0.0;        /* the k-means split_once rounds */
  double pairs_s = 0.0;         /* leaf_distances */
  double upgma_s = 0.0;         /* upgma_build's joins */
  double pairs_computed = 0.0;  /* pair_distance_biased calls */
  double pairs_needed = 0.0;    /* ns * (ns - 1) / 2 a leaf set */
};

using Clock = std::chrono::steady_clock;

double seconds_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

struct TreeBuildCtx {
  const uint8_t* flat;
  const int64_t* off;
  const int32_t* len;
  const float* dm;     /* [numseq][stride] anchor distances */
  int stride;
  int n_anchors;
  int numseq;
  TreeStats* stats;
};

/* L2 distance over `n` floats with AVX2 lane semantics: 8 parallel lane
   accumulators filled chunk-by-chunk, then the reference's hsum tree. */
float edist_lanes8(const float* a, const float* b, int n) {
  float lane[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int c = 0; c < n; c += 8) {
    for (int l = 0; l < 8; l++) {
      float t = a[c + l] - b[c + l];
      lane[l] = lane[l] + t * t;
    }
  }
  float s0 = lane[0] + lane[4];
  float s1 = lane[1] + lane[5];
  float s2 = lane[2] + lane[6];
  float s3 = lane[3] + lane[7];
  return sqrtf((s0 + s1) + (s2 + s3));
}

/* epsilon compare (bisectingKmeans.c:63-73) */
int cmp_floats(float a, float b) {
  const float eps = 1e-6f;
  if (fabsf(a - b) < eps) return 0;
  return a > b ? 1 : -1;
}

struct SplitResult {
  std::vector<int> left, right;
  float score = FLT_MAX;
};

/* One seeded 2-means try (split2, bisectingKmeans.c:766-971). */
void split_once(const TreeBuildCtx& ctx, const std::vector<int>& samples,
                int seed_pick, SplitResult* res) {
  const int na = ctx.n_anchors;
  const int nv = ((na + 7) / 8) * 8;
  const int ns = (int)samples.size();
  std::vector<float> wl(nv, 0.0f), wr(nv, 0.0f), cl(nv, 0.0f), cr(nv, 0.0f),
      mean(nv, 0.0f);

  res->left.resize(ns);
  res->right.resize(ns);
  res->score = FLT_MAX;

  for (int i = 0; i < ns; i++) {
    const float* row = ctx.dm + (int64_t)samples[i] * ctx.stride;
    for (int j = 0; j < na; j++) mean[j] += row[j];
  }
  for (int j = 0; j < na; j++) mean[j] /= (float)ns;

  {
    const float* row = ctx.dm + (int64_t)samples[seed_pick] * ctx.stride;
    for (int j = 0; j < na; j++) cl[j] = row[j];
    /* mirror seed through the mean for the second centroid */
    for (int j = 0; j < na; j++) cr[j] = mean[j] - (cl[j] - mean[j]);
  }

  int num_l = 0, num_r = 0;
  float score = 0.0f;
  for (int iter = 0; iter < 500; iter++) {
    num_l = 0;
    num_r = 0;
    for (int j = 0; j < na; j++) {
      wl[j] = 0.0f;
      wr[j] = 0.0f;
    }
    score = 0.0f;
    for (int i = 0; i < ns; i++) {
      const int s = samples[i];
      const float* row = ctx.dm + (int64_t)s * ctx.stride;
      float dl = edist_lanes8(row, cl.data(), na);
      float dr = edist_lanes8(row, cr.data(), na);
      score += (dl < dr) ? dl : dr;

      float* w;
      int c = cmp_floats(dr, dl);
      if (c == -1) {
        w = wr.data();
        res->right[num_r++] = s;
      } else if (c == 1) {
        w = wl.data();
        res->left[num_l++] = s;
      } else if (i & 1) { /* tie: alternate sides by sample index */
        w = wr.data();
        res->right[num_r++] = s;
      } else {
        w = wl.data();
        res->left[num_l++] = s;
      }
      for (int j = 0; j < na; j++) w[j] += row[j];
    }
    if (num_l == 0 || num_r == 0) {
      /* degenerate: halve the sample list (bisectingKmeans.c:903-917) */
      score = 0.0f;
      num_l = 0;
      num_r = 0;
      for (int i = 0; i < ns / 2; i++) res->left[num_l++] = samples[i];
      for (int i = ns / 2; i < ns; i++) res->right[num_r++] = samples[i];
      break;
    }
    for (int j = 0; j < na; j++) {
      wl[j] /= (float)num_l;
      wr[j] /= (float)num_r;
    }
    int moved = 0;
    for (int j = 0; j < na; j++) {
      if (cmp_floats(wl[j], cl[j]) != 0 || cmp_floats(wr[j], cr[j]) != 0) {
        moved = 1;
        break;
      }
    }
    if (!moved) break;
    std::swap(cl, wl);
    std::swap(cr, wr);
  }
  res->left.resize(num_l);
  res->right.resize(num_r);
  res->score = score;
}

/* UPGMA over a local pairwise matrix; indices into `samples` give global
   leaf ids (bisectingKmeans.c:974-1053).  dm is modified in place. */
TreeNode* upgma_build(std::vector<float>& dm, const std::vector<int>& samples) {
  const int n = (int)samples.size();
  const int nprof = 2 * n - 1;
  std::vector<int> active(n);
  for (int i = 0; i < n; i++) active[i] = i + 1;
  std::vector<TreeNode*> nodes(n);
  for (int i = 0; i < n; i++) {
    nodes[i] = new TreeNode();
    nodes[i]->id = samples[i];
  }
  int cnode = n;
  int node_a = 0, node_b = 0;
  while (cnode != nprof) {
    float best = FLT_MAX;
    for (int i = 0; i < n - 1; i++) {
      if (!active[i]) continue;
      for (int j = i + 1; j < n; j++) {
        if (!active[j]) continue;
        if (dm[(int64_t)i * n + j] < best) {
          best = dm[(int64_t)i * n + j];
          node_a = i;
          node_b = j;
        }
      }
    }
    TreeNode* parent = new TreeNode();
    parent->left = nodes[node_a];
    parent->right = nodes[node_b];
    nodes[node_a] = parent;
    nodes[node_b] = nullptr;
    active[node_a] = cnode + 1;
    active[node_b] = 0;
    cnode++;
    for (int j = n; j--;) {
      if (j != node_b) {
        dm[(int64_t)node_a * n + j] =
            (dm[(int64_t)node_a * n + j] + dm[(int64_t)node_b * n + j]) * 0.5f +
            0.001f;
      }
    }
    dm[(int64_t)node_a * n + node_a] = 0.0f;
    for (int j = n; j--;) dm[(int64_t)j * n + node_a] = dm[(int64_t)node_a * n + j];
  }
  return nodes[node_a];
}

float pair_distance_biased(const TreeBuildCtx& ctx, int a, int b) {
  const uint8_t* sa = ctx.flat + ctx.off[a];
  const uint8_t* sb = ctx.flat + ctx.off[b];
  /* reuse the distance module helpers */
  uint32_t d;
  if (ctx.len[a] > ctx.len[b]) {
    d = (uint32_t)kt_bpm_block(sa, sb, ctx.len[a], ctx.len[b]);
  } else {
    d = (uint32_t)kt_bpm_block(sb, sa, ctx.len[b], ctx.len[a]);
  }
  float dist = (float)d;
  int s = (ctx.len[a] + ctx.len[b]) / 2;
  double add = (10000.0 < (double)s ? 10000.0 : (double)s) / 10000.0;
  dist += (float)add;
  return dist;
}

/* The pair distances the UPGMA of a leaf set s[0..ns) reads, each distinct
   unordered pair once: for members p < q, pair_distance_biased(s[q], s[p])
   into both cells, the value the reference's loop over every ordered pair
   leaves there (its later write, i = q and j = p, wins).  The diagonal,
   which upgma_build never reads, stays 0. */
void leaf_distances(const TreeBuildCtx& ctx, const int32_t* s, int ns,
                    float* dm) {
  for (int q = 1; q < ns; q++) {
    for (int p = 0; p < q; p++) {
      const float d = pair_distance_biased(ctx, s[q], s[p]);
      dm[(int64_t)p * ns + q] = d;
      dm[(int64_t)q * ns + p] = d;
    }
  }
}

/* The splits' product: the tree above the leaf sets in pre-order (-1 a
   split, else the size of the next leaf set), and the leaf sets' members,
   one set after another, each in the order its UPGMA takes them. */
struct LeafSets {
  std::vector<int32_t> shape;
  std::vector<int32_t> members;
};

/* Bisecting 2-means down to sets below the UPGMA threshold
   (bisectingKmeans.c:177-241). */
void split_down(const TreeBuildCtx& ctx, std::vector<int> samples,
                LeafSets* out) {
  const int ns = (int)samples.size();
  if (ns < kUpgmaThreshold) {
    out->shape.push_back(ns);
    out->members.insert(out->members.end(), samples.begin(), samples.end());
    return;
  }

  const Clock::time_point t0 = Clock::now();
  int tries = 40 < ns ? 40 : ns;
  int step = ns / tries;
  SplitResult best;
  bool have_best = false;
  SplitResult rounds[4];
  for (int i = 0; i < tries; i += 4) {
    int change = 0;
    for (int j = 0; j < 4; j++) {
      split_once(ctx, samples, (i + j) * step, &rounds[j]);
    }
    for (int j = 0; j < 4; j++) {
      if (!have_best) {
        best = std::move(rounds[j]);
        have_best = true;
        change++;
      } else if (best.score > rounds[j].score) {
        best = std::move(rounds[j]);
        change++;
      }
    }
    if (!change) break;
  }
  ctx.stats->splits_s += seconds_since(t0);

  out->shape.push_back(-1);
  samples.clear();
  samples.shrink_to_fit();
  split_down(ctx, std::move(best.left), out);
  split_down(ctx, std::move(best.right), out);
}

/* Where join_up reads the splits' product, and the leaf sets' distance
   matrices when the caller gives them (null: leaf_distances computes
   them). */
struct JoinCursor {
  const int32_t* shape;
  const int32_t* members;
  const float* leaf_dm;
  int at = 0;
  int64_t member_at = 0;
  int64_t dm_at = 0;
};

/* The tree of the splits, each leaf set an exact UPGMA over its pair
   distances (d_estimation pair=1, sequence_distance.c:53-81). */
TreeNode* join_up(const TreeBuildCtx& ctx, JoinCursor* c) {
  const int ns = c->shape[c->at++];
  if (ns < 0) {
    TreeNode* n = new TreeNode();
    n->left = join_up(ctx, c);
    n->right = join_up(ctx, c);
    return n;
  }
  const int32_t* s = c->members + c->member_at;
  c->member_at += ns;
  const int64_t cells = (int64_t)ns * ns;
  std::vector<float> dm(cells, 0.0f);
  const double pairs = (double)ns * (double)(ns - 1) / 2.0;
  if (c->leaf_dm) {
    std::copy(c->leaf_dm + c->dm_at, c->leaf_dm + c->dm_at + cells,
              dm.begin());
    c->dm_at += cells;
  } else {
    const Clock::time_point t0 = Clock::now();
    leaf_distances(ctx, s, ns, dm.data());
    ctx.stats->pairs_s += seconds_since(t0);
    ctx.stats->pairs_computed += pairs;
  }
  ctx.stats->pairs_needed += pairs;
  const Clock::time_point t1 = Clock::now();
  TreeNode* joined = upgma_build(dm, std::vector<int>(s, s + ns));
  ctx.stats->upgma_s += seconds_since(t1);
  return joined;
}

int label_postorder(TreeNode* n, int label) {
  if (n->left) label = label_postorder(n->left, label);
  if (n->right) label = label_postorder(n->right, label);
  if (n->id == -1) n->id = label++;
  return label;
}

void emit_tasks_preorder(TreeNode* n, int32_t* tasks, int* count) {
  if (n->left && n->right) {
    tasks[*count * 3 + 0] = n->left->id;
    tasks[*count * 3 + 1] = n->right->id;
    tasks[*count * 3 + 2] = n->id;
    (*count)++;
  }
  if (n->left) emit_tasks_preorder(n->left, tasks, count);
  if (n->right) emit_tasks_preorder(n->right, tasks, count);
}

void free_tree(TreeNode* n) {
  if (!n) return;
  free_tree(n->left);
  free_tree(n->right);
  delete n;
}

TreeBuildCtx make_ctx(const uint8_t* flat, const int64_t* off,
                      const int32_t* len, int32_t numseq, const float* dm,
                      int32_t n_anchors, TreeStats* stats) {
  TreeBuildCtx ctx;
  ctx.flat = flat;
  ctx.off = off;
  ctx.len = len;
  ctx.dm = dm;
  ctx.stride = ((n_anchors + 7) / 8) * 8;
  ctx.n_anchors = n_anchors;
  ctx.numseq = numseq;
  ctx.stats = stats;
  return ctx;
}

LeafSets split_all(const TreeBuildCtx& ctx) {
  std::vector<int> samples(ctx.numseq);
  for (int i = 0; i < ctx.numseq; i++) samples[i] = i;
  LeafSets sets;
  split_down(ctx, std::move(samples), &sets);
  return sets;
}

void write_stats(const TreeStats& stats, double* stats_out) {
  if (stats_out) {
    const double out[5] = {stats.splits_s, stats.pairs_s, stats.upgma_s,
                           stats.pairs_computed, stats.pairs_needed};
    std::memcpy(stats_out, out, sizeof out);
  }
}

}  // namespace

extern "C" int32_t kt_tree_leaf_sets(const float* dm, int32_t n_anchors,
                                     int32_t numseq, int32_t* shape_out,
                                     int32_t* members_out,
                                     double* stats_out) {
  TreeStats stats;
  const LeafSets sets = split_all(
      make_ctx(nullptr, nullptr, nullptr, numseq, dm, n_anchors, &stats));
  std::copy(sets.shape.begin(), sets.shape.end(), shape_out);
  std::copy(sets.members.begin(), sets.members.end(), members_out);
  write_stats(stats, stats_out);
  return (int32_t)sets.shape.size();
}

extern "C" void kt_leaf_distances(const uint8_t* flat, const int64_t* off,
                                  const int32_t* len,
                                  const int32_t* members, int32_t ns,
                                  float* dm_out) {
  TreeStats stats;
  const TreeBuildCtx ctx =
      make_ctx(flat, off, len, 0, nullptr, 0, &stats);
  std::fill(dm_out, dm_out + (int64_t)ns * ns, 0.0f);
  leaf_distances(ctx, members, ns, dm_out);
}

extern "C" int32_t kt_build_tree(const uint8_t* flat, const int64_t* off,
                                 const int32_t* len, int32_t numseq,
                                 const float* dm, int32_t n_anchors,
                                 const int32_t* shape, const int32_t* members,
                                 const float* leaf_dm, int32_t* tasks_out,
                                 float* seq_dist_out, double* stats_out) {
  TreeStats stats;
  const TreeBuildCtx ctx =
      make_ctx(flat, off, len, numseq, dm, n_anchors, &stats);
  LeafSets sets;
  if (!shape) {
    sets = split_all(ctx);
    shape = sets.shape.data();
    members = sets.members.data();
  }
  JoinCursor cursor;
  cursor.shape = shape;
  cursor.members = members;
  cursor.leaf_dm = leaf_dm;
  TreeNode* root = join_up(ctx, &cursor);
  label_postorder(root, numseq);
  int count = 0;
  emit_tasks_preorder(root, tasks_out, &count);
  free_tree(root);

  /* per-sequence normalized mean anchor distance
     (bisectingKmeans.c:242-256) */
  if (seq_dist_out) {
    for (int i = 0; i < numseq; i++) {
      float sum = 0.0f;
      const float* row = dm + (int64_t)i * ctx.stride;
      for (int j = 0; j < n_anchors; j++) sum += row[j];
      float mean = sum / (float)n_anchors;
      float sl = (float)len[i];
      seq_dist_out[i] = sl > 0.0f ? mean / sl : 0.0f;
    }
  }
  write_stats(stats, stats_out);
  return count;
}

extern "C" int32_t kt_build_tree_pairwise(float* dm, int32_t numseq,
                                          int32_t* tasks_out,
                                          float* seq_dist_out) {
  /* mean pairwise distance BEFORE upgma mutates dm
     (bisectingKmeans.c:1167-1178) */
  if (seq_dist_out) {
    for (int i = 0; i < numseq; i++) {
      float sum = 0.0f;
      for (int j = 0; j < numseq; j++) {
        if (j != i) sum += dm[(int64_t)i * numseq + j];
      }
      seq_dist_out[i] = numseq > 1 ? sum / (float)(numseq - 1) : 0.0f;
    }
  }
  std::vector<int> samples(numseq);
  for (int i = 0; i < numseq; i++) samples[i] = i;
  std::vector<float> work(dm, dm + (int64_t)numseq * numseq);
  TreeNode* root = upgma_build(work, samples);
  label_postorder(root, numseq);
  int count = 0;
  emit_tasks_preorder(root, tasks_out, &count);
  free_tree(root);
  return count;
}
